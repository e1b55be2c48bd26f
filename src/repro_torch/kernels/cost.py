"""The closed-form cost of each hand-written kernel: the operations it
must do and the bytes it must move for one call, and the least time an
H100 could take for them.

One function a kernel, keyed by the kernel's name in :func:`cost`:

* bytes: every input read once and every output written once, in the
  call's element size (``el``), the lengths, lse and delta rows and the
  SSD scan's a, d and states as their own types; a cache kernel reads
  only the KV rows its lengths make valid, and a paged kernel the table
  entries it follows;
* operations: two a multiply-add, over the score entries the mask
  keeps: a causal row anchored at ``lengths - Sq`` (or, cache-free, at
  ``q_offset``) sees its prefix and no more; softmax, RoPE and the
  rescales add none, as in any closed form.

``lengths`` is a sequence of ints, one a batch row, or None: every
column of the cache valid (a filled prefix).  The kernel wrappers
report their call's cost through :func:`counted`, where ``lengths`` is
always None: reading device lengths back would stall every call, and a
meta tensor has none.  ``chip_smoke.py`` passes the lengths of its
inputs, so its bound counts what that data needs.

:func:`counted` and :func:`collective` are the hooks of the cost
counter (``launch/cost_analysis.py``), which installs itself with
:func:`set_counter`; with none installed they cost one attribute read.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence

#: the NVIDIA H100 SXM5 80GB's data sheet (700 W): HBM3 bytes a second
#: and dense bf16 tensor-core operations a second
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12


def bound_ms(flops: float, bytes_: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the bf16 rate, and which it is."""
    tb, tf = bytes_ / PEAK_BYTES, flops / PEAK_BF16
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _clamped_sum(lo: int, hi: int, cap: int) -> int:
    """sum of min(max(t, 0), cap) for t in [lo, hi]."""
    if hi < lo:
        return 0
    total = 0
    a, b = max(lo, 1), min(hi, cap)          # the part in [1, cap]
    if b >= a:
        total += (a + b) * (b - a + 1) // 2
    c = max(lo, cap + 1)                      # the part above cap
    if hi >= c:
        total += cap * (hi - c + 1)
    return total


def cached_work(sq: int, lengths: Sequence[int], causal: bool) -> tuple:
    """(score entries a query head, KV rows) summed over the batch rows
    of a cache kernel: row r of a batch row of length n sees columns
    below n and, causal, at most n - Sq + r."""
    ent = rows = 0
    for n in lengths:
        n = int(n)
        ent += _clamped_sum(n - sq + 1, n, n) if causal else sq * n
        rows += n
    return ent, rows


def train_entries(b: int, hq: int, sq: int, skv: int, causal: bool,
                  q_offset: Optional[int] = None) -> int:
    """Score entries of a cache-free attention: (B * Hq) rows, row r of
    which sees columns up to ``q_offset + r`` (default Skv - Sq) when
    causal, all Skv otherwise."""
    if not causal:
        return b * hq * sq * skv
    off = skv - sq if q_offset is None else int(q_offset)
    return b * hq * _clamped_sum(off + 1, off + sq, skv)


def _lengths(b: int, skv: int, lengths) -> list:
    return [skv] * b if lengths is None else list(lengths)


def fused_attention_masked(b, hq, hkv, sq, skv, d, dv, *, lengths=None,
                           causal=True, el=2, v_in_k=False, table=0):
    """#1 (and #4 with ``table``, the table entries it reads; ``skv``
    the table's depth, max_pages * page): q read, o written, the valid
    K/V rows read (K's rows alone where V is their first Dv columns:
    MLA's latent, the wide body), the lengths."""
    ent, rows = cached_work(sq, _lengths(b, skv, lengths), causal)
    kv = rows * hkv * (d if v_in_k else d + dv)
    return (2 * hq * (d + dv) * ent,
            el * (b * hq * sq * (d + dv) + kv) + 4 * b + 4 * table)


def fused_qproj_attention_masked(b, sq, e, hq, hkv, skv, d, dv, *,
                                 lengths=None, causal=True, el=2, table=0):
    """#2 (and #5 with ``table``): x and Wq read, Q = x.Wq computed and
    never stored, then #1's work."""
    ent, rows = cached_work(sq, _lengths(b, skv, lengths), causal)
    return (2 * b * sq * e * hq * d + 2 * hq * (d + dv) * ent,
            el * (b * sq * e + e * hq * d + rows * hkv * (d + dv)
                  + b * sq * hq * dv) + 4 * b + 4 * table)


def fused_decode_block(b, e, hq, hkv, skv, d, dv, *, lengths=None, el=2,
                       table=0):
    """#3 (and #6 with ``table``): x, the residual and the output, Wq
    and Wo, the valid K/V rows and the lengths; the Q and output
    projections and the scores of one row a batch row."""
    _, rows = cached_work(1, _lengths(b, skv, lengths), False)
    return (2 * b * e * hq * d + 2 * hq * (d + dv) * rows
            + 2 * b * hq * dv * e,
            el * (3 * b * e + e * hq * d + hq * dv * e
                  + rows * hkv * (d + dv)) + 4 * b + 4 * table)


def fused_attention_fwd(b, hq, hkv, sq, skv, d, dv, *, causal=True,
                        q_offset=None, el=2):
    """#7: q, k, v read, o and the fp32 lse written; S = Q.K^T and
    O = P.V over the kept entries."""
    ent = train_entries(b, hq, sq, skv, causal, q_offset)
    return (2 * (d + dv) * ent,
            el * (b * hq * sq * (d + dv) + b * hkv * skv * (d + dv))
            + 4 * b * hq * sq)


def fused_attention_bwd_dq(b, hq, hkv, sq, skv, d, dv, *, causal=True,
                           q_offset=None, el=2):
    """#8: q, k, v, do, lse and delta read, dq written; S, dP = dO.V^T
    and dQ = dS.K."""
    ent = train_entries(b, hq, sq, skv, causal, q_offset)
    return ((4 * d + 2 * dv) * ent,
            el * (2 * b * hq * sq * d + b * hkv * skv * (d + dv)
                  + b * hq * sq * dv) + 8 * b * hq * sq)


def fused_attention_bwd_dkv(b, hq, hkv, sq, skv, d, dv, *, causal=True,
                            q_offset=None, el=2):
    """#9: q, k, v, do, lse and delta read, dk and dv written; S, dP,
    dV = P^T.dO and dK = dS^T.Q."""
    ent = train_entries(b, hq, sq, skv, causal, q_offset)
    return (4 * (d + dv) * ent,
            el * (b * hq * sq * (d + dv) + 2 * b * hkv * skv * (d + dv))
            + 8 * b * hq * sq)


def fused_qproj_attention_fwd(b, sq, e, hq, hkv, skv, d, dv, *,
                              causal=True, q_offset=None, el=2):
    """#10: x, Wq, k and v read, o and lse written; Q = x.Wq, then #7's
    products."""
    ent = train_entries(b, hq, sq, skv, causal, q_offset)
    return (2 * b * sq * e * hq * d + 2 * (d + dv) * ent,
            el * (b * sq * e + e * hq * d + b * hkv * skv * (d + dv)
                  + b * hq * sq * dv) + 4 * b * hq * sq)


def ssd_scan(b, length, h, p, g, s, chunk, *, el=2, h0=False, d=True):
    """#11: x and y, dt, B and C in the call's element size, a (and d)
    fp32, the fp32 final state written (and h0 read); per head and chunk
    of n rows, the causal n(n+1)/2 entries of C.B^T (S each) and of the
    score product (P each), C.h and the state update (P S each a row)."""
    byts = (2 * b * length * h * p + b * length * h
            + 2 * b * length * g * s) * el + (2 if d else 1) * h * 4 \
        + (2 if h0 else 1) * b * h * p * s * 4
    ops = 0
    for start in range(0, length, chunk):
        n = min(chunk, length - start)
        ops += 2 * (n * (n + 1) // 2 * (s + p) + 2 * n * p * s)
    return ops * b * h, byts


#: kernel name (``build.KERNELS``) -> its closed form; a paged kernel's
#: is its dense twin's, with the table entries it reads
COSTS = dict({f.__name__: f for f in (
    fused_attention_masked, fused_qproj_attention_masked, fused_decode_block,
    fused_attention_fwd, fused_attention_bwd_dq, fused_attention_bwd_dkv,
    fused_qproj_attention_fwd, ssd_scan)},
    fused_attention_paged=fused_attention_masked,
    fused_qproj_attention_paged=fused_qproj_attention_masked,
    fused_decode_block_paged=fused_decode_block)


def cost(kernel: str, *args, **kw) -> tuple:
    """(operations, bytes) of one call of ``kernel``."""
    return COSTS[kernel](*args, **kw)


# ---------------------------------------------------------------------------
# the counter's hooks
# ---------------------------------------------------------------------------

#: the active cost counter (``launch.cost_analysis``), or None
_COUNTER = None


def set_counter(counter) -> None:
    """Install (or, with None, remove) the counter that :func:`counted`
    and :func:`collective` report to; one at a time."""
    global _COUNTER
    if counter is not None and _COUNTER is not None:
        raise RuntimeError("a cost count is already running")
    _COUNTER = counter


def collective(op: str, nbytes: int) -> None:
    """Report a collective's per-device output bytes under ``op``
    (JAX's HLO names: all-gather, all-reduce, all-to-all, ...)."""
    if _COUNTER is not None:
        _COUNTER.collective(op, nbytes)


@contextlib.contextmanager
def inside_collective():
    """The body of one ``torch.distributed`` call: the aten ops a backend
    runs inside it (gloo's ``reduce_scatter_tensor`` and
    ``all_gather_into_tensor`` split and copy on the host) are the
    collective's, so an active counter counts no bytes for them."""
    counter = _COUNTER
    if counter is None or counter.in_kernel:
        yield
        return
    counter.in_kernel = True
    try:
        yield
    finally:
        counter.in_kernel = False


def counted(kernel: str, shapes: Callable,
            when: Optional[Callable] = None) -> Callable:
    """Decorate a kernel wrapper or its plain version: under an active
    counter a call reports ``cost(kernel, *args, **kw)`` with ``(args,
    kw) = shapes(*call_args, **call_kw)``, and the operations and bytes
    of the aten ops inside it are not counted again.  A call inside
    another counted call is the outer one's.  ``when(*call_args,
    **call_kw)`` False: the call is counted as the aten ops it runs (a
    plain version differentiated by autograd, which no kernel stands
    in for)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            counter = _COUNTER
            if counter is None or counter.in_kernel \
                    or (when is not None and not when(*a, **kw)):
                return fn(*a, **kw)
            sa, skw = shapes(*a, **kw)
            with counter.kernel(kernel, *cost(kernel, *sa, **skw)):
                return fn(*a, **kw)
        return run
    return deco
