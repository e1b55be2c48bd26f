"""Plan-driven kernel dispatch (a port of ``repro/kernels/ops.py``).

Three entry points, one per rung of the fusion ladder that carries a
kernel:

* ``attention``       -- scores over a given Q (Fig. 5c):
  ``fused_attention_masked`` over a KV cache; without ``lengths`` (the
  cache-free training and prefill call) the differentiable
  ``fused_attention`` (forward ``fused_attention_fwd``, backward
  ``fused_attention_bwd_dq`` and ``fused_attention_bwd_dkv``);
* ``qproj_attention`` -- Q = x @ Wq folded into the score kernel, RoPE
  in-kernel (Fig. 5b): ``fused_qproj_attention_masked`` over a KV cache;
  without ``lengths`` the differentiable ``fused_qproj_attention``
  (forward ``fused_qproj_attention_fwd``, the same backward kernels);
* ``decode_block``    -- the whole M=1 sub-block through the residual
  add: ``fused_decode_block``;
* ``ssd``             -- the Mamba-2 chunked SSD scan: ``ssd_scan``, with
  an optional initial state (the serve path's prefill chunks); and
  ``ssd_step``, its one-token decode update (plain PyTorch, as the JAX
  package's is plain lax).

Each takes ``impl``: ``cuda`` (the kernel), ``torch`` (its plain
version) or ``reference`` (the unfused oracle the plan picks below the
crossovers).  With ``block_tables`` (B, max_pages) the K/V arguments
are page pools (num_pages, Hkv, page, D) and each entry point takes its
paged kernel (``fused_attention_paged``, ``fused_qproj_attention_paged``,
``fused_decode_block_paged``), its plain version, or the oracle over
the gathered pool.  A ``plan`` (``lower.runtime.PlanDispatch``) supplies the
impl and receives downgrade records.  Without one, ``auto`` resolves
through the plan cache as in the JAX package: the call's shapes alone
key a plan (``lower.cache.kernel_plan``), whose kernel path picks the
kernel (``cuda`` on a CUDA tensor, ``torch`` on a CPU one) or, below
the crossovers, the unfused ``reference``, and that plan receives the
call's downgrade records.  ``schedule_for`` is the paper's shape rule
by name.

A call the masked kernels cannot express (a dtype outside fp32/bf16/
fp16, malformed lengths, an explicit causal offset other than the
kernels' anchor ``lengths - Sq``: the reasons of the JAX package's
``_masked_unsupported``) warns once per reason and runs the reference
instead, with the reason recorded on the plan: never a silently
different answer.  Any other limit of a kernel (a head wider than it
takes, a dtype it was not built for) is the wrapper's, which raises; so
does a kernel that fails to build or launch.  Nothing falls back.  A
paged call the paged kernels cannot express (the reasons of the JAX
package's ``_paged_unsupported``: a malformed table, a page size off
the multiple of 8, and every masked reason) does the same, naming the
paged-KV kernel.

``CALLS[(entry, impl)]`` counts calls per entry point and impl, with
``_paged`` appended to the entry of a paged call; the kernels' own
launch counts are ``build.LAUNCHES``.

A fault injector installed with :func:`set_fault_injector` (the serving
layer's ``serve.faults.FaultInjector``) is consulted by every attention
entry point once its impl is resolved, before any refusal onto the
reference, with the plain entry name also for a paged call, as the JAX
package's ``_resolve`` consults it.  It may raise
:class:`KernelLaunchError`, on which the serving supervisor rungs down;
a call that raises is not counted.  ``ssd`` has no injection point, as
in the JAX package.  Only the injector raises that error: a kernel that
fails to build or launch, or a wrapper that refuses a shape, raises its
own error, which nothing here catches.
"""

from __future__ import annotations

import collections
import warnings
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_attention import (
    fused_attention, fused_attention_masked, fused_attention_masked_plain,
    fused_attention_paged, fused_attention_paged_plain, is_column_prefix)
from repro_torch.kernels.fused_decode_block import (
    fused_decode_block, fused_decode_block_paged,
    fused_decode_block_paged_plain, fused_decode_block_plain)
from repro_torch.kernels.fused_qproj_attention import (
    fused_qproj_attention, fused_qproj_attention_masked,
    fused_qproj_attention_masked_plain, fused_qproj_attention_paged,
    fused_qproj_attention_paged_plain)
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.core.fusion import select_schedule
from repro_torch.lower import runtime as _plan_rt

__all__ = ["attention", "qproj_attention", "decode_block", "ssd",
           "ssd_step", "schedule_for", "CALLS", "reset_counts",
           "reset_downgrade_warnings", "KernelLaunchError",
           "set_fault_injector"]

IMPLS = ("cuda", "torch", "reference")
CALLS: collections.Counter = collections.Counter()

_MASKED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_warned_downgrade_reasons: set = set()


def schedule_for(seq_q: int, d_head: int) -> str:
    """The paper's shape rule with M = query rows, N = head width:
    'fuse_pv' (Fig. 5c) for M > N, 'fuse_q_qkt' (Fig. 5b) for M < N,
    'lbl' at M == N."""
    return select_schedule(seq_q, d_head)


def reset_counts() -> None:
    """Zero the per-impl call counts and the kernels' launch counts."""
    CALLS.clear()
    build.reset_launches()


def reset_downgrade_warnings() -> None:
    _warned_downgrade_reasons.clear()


class KernelLaunchError(RuntimeError):
    """A kernel launch failed at dispatch: raised by an installed fault
    injector (``serve/faults.py``); the serving supervisor recovers by
    rung-down on the lowering ladder."""


#: the process-wide fault-injection hook; None outside chaos runs
_fault_injector = None


def set_fault_injector(inj) -> None:
    """Install (or clear, with ``None``) a fault injector whose
    ``on_kernel(entry, impl)`` runs after each attention entry point
    resolves its impl."""
    global _fault_injector
    _fault_injector = inj


def _maybe_inject(entry: str, impl: str) -> None:
    if _fault_injector is not None:
        _fault_injector.on_kernel(entry, impl)


def _downgrade(plan, reason: str, kernel: str) -> str:
    """A call the masked kernels cannot express: warn once per (kernel,
    reason), record the reason on the plan, run the reference."""
    key = (kernel, reason)
    if key not in _warned_downgrade_reasons:
        warnings.warn(f"attention: call cannot take the {kernel} "
                      f"({reason}); running the unfused reference "
                      "(recorded on the ExecutionPlan)", stacklevel=4)
        _warned_downgrade_reasons.add(key)
    if plan is not None:
        plan.plan.record_downgrade(f"{kernel} unavailable: {reason}",
                                   plan.path, plan.path)
    return "reference"


def _masked_unsupported(x, lengths, causal: bool, q_offset,
                        sq: int) -> Optional[str]:
    """Why the masked kernels (and their plain versions, which share
    their anchor) cannot serve this call, or None.  An explicit causal
    ``q_offset`` is checked against ``lengths - Sq`` when the lengths
    are on the host; on the card it is trusted, as the JAX package
    trusts traced values: the model builds ``lengths = cache_len + Sq``
    and ``q_offset = cache_len`` together, and reading device lengths
    back would stall every call."""
    if x.dtype not in _MASKED_DTYPES:
        return f"dtype {x.dtype} outside {_MASKED_DTYPES}"
    if lengths.ndim != 1:
        return f"lengths must be (B,), got shape {tuple(lengths.shape)}"
    if lengths.is_floating_point() or lengths.is_complex():
        return f"lengths must be integral, got {lengths.dtype}"
    if causal and q_offset is None and sq > 1:
        return ("causal multi-row lengths call without q_offset: pass "
                "q_offset = lengths - Sq (the masked kernel's anchor)")
    if causal and q_offset is not None and lengths.device.type == "cpu":
        lens = [int(n) for n in lengths]
        if any(n - sq != int(q_offset) for n in lens):
            return (f"explicit q_offset={int(q_offset)} inconsistent with "
                    f"the masked kernel's causal anchor lengths - Sq "
                    f"({[n - sq for n in lens]})")
    return None


def _paged_unsupported(x, lengths, block_tables, causal: bool, q_offset,
                       sq: int, page: int) -> Optional[str]:
    """Why the paged kernels cannot serve this call, or None: every
    masked-kernel reason (they share the body) plus the block-table
    contract, a 2-D integral (B, max_pages) table and a page size that
    is a multiple of 8 (the JAX package's sublane alignment, kept so
    both packages refuse the same calls)."""
    if lengths is None:
        return "paged call without lengths (the table has no row depth)"
    if block_tables.ndim != 2:
        return ("block_tables must be (B, max_pages), got shape "
                f"{tuple(block_tables.shape)}")
    if block_tables.is_floating_point() or block_tables.is_complex() \
            or block_tables.dtype == torch.bool:
        return f"block_tables must be integral, got {block_tables.dtype}"
    if block_tables.shape[0] != lengths.shape[0]:
        return (f"block_tables rows {block_tables.shape[0]} != "
                f"lengths rows {lengths.shape[0]}")
    if page % 8:
        return f"page size {page} not sublane-aligned (8)"
    return _masked_unsupported(x, lengths, causal, q_offset, sq)


def _auto_dispatch(entry: str, sq: int, skv: int, d: int, hq: int,
                   hkv: int, lengths_masked: bool, device):
    """Resolve a plan-less ``impl="auto"`` through the plan cache: the
    shape-only plan legalised for this entry point on ``device``.  None
    where the shapes are no DSE workload (``lowering.supported``); the
    caller then takes the device's kernel or plain version."""
    return _plan_rt.shape_dispatch(seq_q=sq, seq_kv=skv, d_head=d,
                                   n_heads=hq, n_kv_heads=hkv,
                                   device=device, entry=entry,
                                   lengths_masked=lengths_masked)


def _resolve(entry: str, impl: str, plan, device, shapes=None):
    """(impl, plan) of one call: a given plan's impl, or for a
    plan-less ``auto`` the shape-only plan's (``shapes`` = (Sq, Skv, D,
    Hq, Hkv, lengths_masked)), or the device's where none applies."""
    if impl == "auto":
        if plan is None and shapes is not None:
            plan = _auto_dispatch(entry, *shapes, device)
        if plan is not None:
            impl = plan.impl
        else:
            impl = "cuda" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return impl, plan


def _count(entry: str, impl: str) -> None:
    CALLS[(entry, impl)] += 1


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None, q_offset=None,
              lengths: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              impl: str = "auto", plan=None):
    """Layer-fused attention (Fig. 5c) or the plan's unfused reference.
    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D[v]).  ``lengths`` (B,):
    valid KV prefix per row; the masked kernel anchors causal rows at
    its end (``q_offset = lengths - Sq``).  A call without lengths runs
    the differentiable ``fused_attention`` over the full Skv, causal rows
    anchored at ``q_offset + r`` (default ``Skv - Sq``), on the kernels
    (``cuda``) or their plain versions (``torch``).  ``block_tables``
    (B, max_pages): k and v are page pools (num_pages, Hkv, page, D[v])
    read through the table (``lengths`` required)."""
    sq = q.shape[2]
    if block_tables is not None:
        return _attention_paged(q, k, v, lengths, block_tables,
                                causal=causal, scale=scale,
                                q_offset=q_offset, impl=impl, plan=plan)
    impl, plan = _resolve("attention", impl, plan, q.device,
                          (sq, k.shape[2], q.shape[3], q.shape[1],
                           k.shape[1], lengths is not None))
    _maybe_inject("attention", impl)
    if lengths is None:
        _count("attention", impl)
        if impl == "reference":
            return ref.attention_reference(q, k, v, causal=causal,
                                           scale=scale, q_offset=q_offset)
        return fused_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, plain=impl == "torch")
    if impl != "reference":
        reason = _masked_unsupported(q, lengths, causal, q_offset, sq)
        if reason is not None:
            impl = _downgrade(plan, reason, "masked attention kernel")
    _count("attention", impl)
    if impl == "reference":
        return ref.attention_reference(q, k, v, causal=causal, scale=scale,
                                       q_offset=q_offset, lengths=lengths)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        k = k.contiguous()
        # MLA's V, a column prefix of its latent K, is passed as the view
        # it is: the wide body reads it from K's tile
        return fused_attention_masked(
            q.contiguous(), k, v if is_column_prefix(k, v)
            else v.contiguous(), lengths, causal=causal, scale=scale)
    return fused_attention_masked_plain(q, k, v, lengths, causal=causal,
                                        scale=scale)


def qproj_attention(x, wq, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, q_offset=None,
                    lengths: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    rope_theta: Optional[float] = None,
                    impl: str = "auto", plan=None):
    """Layer-fused Q-projection attention (Fig. 5b): x (B, Sq, E) and
    wq (E, Hq, D) go to the kernel, which builds (and, with
    ``rope_theta``, rotates at ``lengths[b] - Sq + r``) the Q tile
    itself.  Without ``lengths`` the differentiable
    ``fused_qproj_attention`` runs over the full Skv, rows anchored and
    rotated at ``q_offset + r`` (default ``Skv - Sq``), as the JAX
    package's cache-free call.  ``block_tables``: k and v are page
    pools, as in :func:`attention`."""
    if block_tables is not None:
        return _qproj_attention_paged(x, wq, k, v, lengths, block_tables,
                                      causal=causal, scale=scale,
                                      q_offset=q_offset,
                                      rope_theta=rope_theta, impl=impl,
                                      plan=plan)
    sq = x.shape[1]
    impl, plan = _resolve("qproj_attention", impl, plan, x.device,
                          (sq, k.shape[2], wq.shape[-1], wq.shape[1],
                           k.shape[1], lengths is not None))
    _maybe_inject("qproj_attention", impl)
    if lengths is None:
        _count("qproj_attention", impl)
        if impl == "reference":
            return ref.qproj_attention_reference(
                x, wq, k, v, rope_theta=rope_theta, causal=causal,
                scale=scale, q_offset=q_offset)
        return fused_qproj_attention(x, wq, k, v, causal=causal,
                                     scale=scale, q_offset=q_offset,
                                     rope_theta=rope_theta,
                                     plain=impl == "torch")
    if impl != "reference":
        reason = _masked_unsupported(x, lengths, causal, q_offset, sq)
        if reason is not None:
            impl = _downgrade(plan, reason, "masked Q-projection kernel")
    _count("qproj_attention", impl)
    if impl == "reference":
        return ref.qproj_attention_reference(
            x, wq, k, v, rope_theta=rope_theta, causal=causal, scale=scale,
            q_offset=q_offset, lengths=lengths)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        return fused_qproj_attention_masked(
            x.contiguous(), wq.contiguous(), k.contiguous(), v.contiguous(),
            lengths, causal=causal, scale=scale, rope_theta=rope_theta)
    return fused_qproj_attention_masked_plain(
        x, wq, k, v, lengths, causal=causal, scale=scale,
        rope_theta=rope_theta)


def decode_block(x, wq, k, v, wo, residual, lengths, *,
                 block_tables: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None,
                 rope_theta: Optional[float] = None, impl: str = "auto",
                 plan=None):
    """The M=1 decode megakernel: Q projection (+ RoPE at
    ``lengths[b] - 1``), masked scores over the valid prefix, softmax,
    P.V, output projection and residual add in one launch.  x, residual:
    (B, 1, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]); wo: (Hq, Dv,
    E).  Returns ``residual + attn_out @ Wo``, (B, 1, E).
    ``block_tables``: k and v are page pools, as in :func:`attention`."""
    if x.shape[1] != 1:
        raise ValueError("decode_block is the M=1 decode schedule")
    if block_tables is not None:
        return _decode_block_paged(x, wq, k, v, wo, residual, lengths,
                                   block_tables, scale=scale,
                                   rope_theta=rope_theta, impl=impl,
                                   plan=plan)
    impl, plan = _resolve("decode_block", impl, plan, x.device,
                          (1, k.shape[2], wq.shape[-1], wq.shape[1],
                           k.shape[1], True))
    _maybe_inject("decode_block", impl)
    if impl != "reference":
        reason = _masked_unsupported(x, lengths, False, None, 1)
        if reason is not None:
            impl = _downgrade(plan, reason, "decode megakernel")
    _count("decode_block", impl)
    if impl == "reference":
        return ref.decode_block_reference(x, wq, k, v, wo, residual,
                                          lengths, rope_theta=rope_theta,
                                          scale=scale)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        return fused_decode_block(
            x.contiguous(), wq.contiguous(), k.contiguous(), v.contiguous(),
            wo.contiguous(), residual.contiguous(), lengths, scale=scale,
            rope_theta=rope_theta)
    return fused_decode_block_plain(x, wq, k, v, wo, residual, lengths,
                                    scale=scale, rope_theta=rope_theta)


# ---------------------------------------------------------------------------
# paged KV: the same entry points over a page pool and block tables
# ---------------------------------------------------------------------------

def _paged_impl(entry: str, x, lengths, block_tables, causal, q_offset,
                sq: int, pool, d: int, hq: int, impl: str, plan) -> str:
    """Resolve a paged call's impl, refusing onto the reference what the
    paged kernels cannot express; counts the call.  ``pool`` is the V
    page pool (num_pages, Hkv, page, Dv): a plan-less ``auto`` keys its
    plan on the table's depth, max_pages * page.  The fault injector
    sees the plain ``entry`` name, as the JAX package names a paged
    call."""
    if lengths is None:
        raise ValueError(f"paged {entry} requires lengths")
    page = pool.shape[2]
    impl, plan = _resolve(entry, impl, plan, x.device,
                          (sq, block_tables.shape[-1] * page, d, hq,
                           pool.shape[1], True))
    _maybe_inject(entry, impl)
    if impl != "reference":
        reason = _paged_unsupported(x, lengths, block_tables, causal,
                                    q_offset, sq, page)
        if reason is not None:
            impl = _downgrade(plan, reason, "paged-KV kernel")
    _count(f"{entry}_paged", impl)
    return impl


def _attention_paged(q, k_pool, v_pool, lengths, block_tables, *, causal,
                     scale, q_offset, impl, plan):
    impl = _paged_impl("attention", q, lengths, block_tables, causal,
                       q_offset, q.shape[2], v_pool, q.shape[3], q.shape[1],
                       impl, plan)
    if impl == "reference":
        return ref.paged_attention_reference(
            q, k_pool, v_pool, lengths, block_tables, causal=causal,
            scale=scale, q_offset=q_offset)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        return fused_attention_paged(
            q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
            lengths, block_tables, causal=causal, scale=scale)
    return fused_attention_paged_plain(q, k_pool, v_pool, lengths,
                                       block_tables, causal=causal,
                                       scale=scale)


def _qproj_attention_paged(x, wq, k_pool, v_pool, lengths, block_tables, *,
                           causal, scale, q_offset, rope_theta, impl, plan):
    impl = _paged_impl("qproj_attention", x, lengths, block_tables, causal,
                       q_offset, x.shape[1], v_pool, wq.shape[-1],
                       wq.shape[1], impl, plan)
    if impl == "reference":
        return ref.paged_qproj_attention_reference(
            x, wq, k_pool, v_pool, lengths, block_tables, causal=causal,
            scale=scale, rope_theta=rope_theta, q_offset=q_offset)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        return fused_qproj_attention_paged(
            x.contiguous(), wq.contiguous(), k_pool.contiguous(),
            v_pool.contiguous(), lengths, block_tables, causal=causal,
            scale=scale, rope_theta=rope_theta)
    return fused_qproj_attention_paged_plain(
        x, wq, k_pool, v_pool, lengths, block_tables, causal=causal,
        scale=scale, rope_theta=rope_theta)


def _decode_block_paged(x, wq, k_pool, v_pool, wo, residual, lengths,
                        block_tables, *, scale, rope_theta, impl, plan):
    impl = _paged_impl("decode_block", x, lengths, block_tables, False,
                       None, 1, v_pool, wq.shape[-1], wq.shape[1], impl,
                       plan)
    if impl == "reference":
        return ref.paged_decode_block_reference(
            x, wq, k_pool, v_pool, wo, residual, lengths, block_tables,
            rope_theta=rope_theta, scale=scale)
    lengths = lengths.to(torch.int32)
    if impl == "cuda":
        return fused_decode_block_paged(
            x.contiguous(), wq.contiguous(), k_pool.contiguous(),
            v_pool.contiguous(), wo.contiguous(), residual.contiguous(),
            lengths, block_tables, scale=scale, rope_theta=rope_theta)
    return fused_decode_block_paged_plain(
        x, wq, k_pool, v_pool, wo, residual, lengths, block_tables,
        scale=scale, rope_theta=rope_theta)


# ---------------------------------------------------------------------------
# Mamba-2: the SSD scan and its decode step
# ---------------------------------------------------------------------------

def ssd(x, dt, a, b, c, d=None, *, chunk: int = 128, impl: str = "auto",
        h0: Optional[torch.Tensor] = None, return_final_state: bool = False):
    """Mamba-2 SSD chunked scan.  x: (B, L, H, P); dt: (B, L, H); a:
    (H,); b, c: (B, L, G, S); d: (H,) or None; h0: (B, H, P, S) initial
    state or None.  ``impl``: ``cuda`` (kernel #11, with or without h0:
    where the JAX package sends a call with h0 to its lax chunked scan,
    the kernel computes that function), ``torch`` (the plain version, the
    port of that lax scan) or ``reference`` (the sequential oracle).

    ``auto`` is decided on the grad mode before the call, as the JAX
    package's ``default_impl`` sends every call off the TPU to its
    differentiable lax scan: where autograd would track an input
    (``torch.is_grad_enabled()`` and one requires grad, a training
    forward) it is the plain version on either device, counted as
    ``("ssd", "torch")``; otherwise the kernel on a CUDA tensor and the
    plain version on a CPU one.  This is no fallback: nothing is tried
    first.  The kernel has no backward (nor has the TPU kernel), so
    ``impl="cuda"`` on a tracked input raises ``NotImplementedError``.
    Returns y, and with ``return_final_state`` the final state fp32."""
    inputs = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d, "h0": h0}
    if impl == "auto" and _ssd.tracked(inputs):
        impl = "torch"
    impl, _ = _resolve("ssd", impl, None, x.device)
    if impl == "cuda":
        _ssd.check_no_grad("ops.ssd", inputs)
    _count("ssd", impl)
    if impl == "reference":
        return ref.ssd_reference(x, dt, a, b, c, d, h0=h0,
                                 return_final_state=return_final_state)
    if impl == "cuda":
        if x.device.type != "cuda":
            raise ValueError(f"ops.ssd: impl 'cuda' on a {x.device} tensor")
        return _ssd.ssd_scan(x, dt, a, b, c, d, chunk=chunk, h0=h0,
                             return_final_state=return_final_state)
    return _ssd.ssd_scan_plain(x, dt, a, b, c, d, chunk=chunk, h0=h0,
                               return_final_state=return_final_state)


def ssd_step(x_t, dt_t, a, b_t, c_t, d, h):
    """One-token SSD update for decode (``kernels.ssd_scan.ssd_step``):
    returns (y (B, H, P), the new state (B, H, P, S) fp32)."""
    _count("ssd_step", "torch")
    return _ssd.ssd_step(x_t, dt_t, a, b_t, c_t, d, h)
