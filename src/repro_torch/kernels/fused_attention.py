"""``fused_attention_masked``: masked-lengths layer-fused attention (the
paper's Fig. 5c schedule over a KV cache), and ``fused_attention_paged``,
the same over a KV page pool, as CUDA kernels for Hopper
(``csrc/fused_attention.cu``) with their plain PyTorch versions; and
``fused_attention``, the training attention: an autograd Function whose
forward is the kernel ``fused_attention_fwd`` (the same body over the
whole sequence, returning lse) and whose backward is
``fused_attention_bwd_dq`` then ``fused_attention_bwd_dkv``
(``csrc/fused_attention_bwd.cu``).

Replace the TPU kernels ``repro/kernels/fused_attention.py``
``fused_attention_masked`` and ``fused_attention_paged``.  Row r of
batch row b attends columns ``c < lengths[b]`` and, under ``causal``,
``c <= lengths[b] - Sq + r`` (the causal triangle anchored at the end
of the valid prefix); rows with no valid column emit zeros.  The paged
kernel reads logical KV block j of row b from pool page
``block_tables[b, j]``; the math is the masked kernel's.  Their
one-pass body runs on the tensor cores in bf16 (64 rows a block) and
as fp32 FMAs in fp32 (16 rows).  Where that grid would have fewer
blocks than the card has SMs (decode), both run a split-KV body
instead, by one rule on the shapes and dtype (:func:`split_chunks`), so
the paged kernel still gives the masked kernel's output on the
gathered cache bit for bit.  Past MAX_HEAD_DIM (up to D = 576, Dv =
512: MLA's absorbed form, 128 query heads over one latent head) the
masked kernel runs a wide body of its own (``csrc/masked_wide.cuh``),
which reads V as the first Dv columns of K's rows (the wrapper takes
such a view of k, and no other V there), with its own split into KV
chunks where its grid would leave SMs idle (:func:`wide_chunks`).
``fused_attention`` replaces the TPU ``custom_vjp`` ``fused_attention``
(forward ``_fwd``, backward ``_bwd``'s dq and dk/dv kernels).  Its three
kernels take heads up to TRAIN_MAX_D and TRAIN_MAX_DV wide, past
MAX_HEAD_DIM for Q and K: MLA's cache-free training attention (D = nope
128 + rope 64, Dv 128, 128 heads, group 1) runs instantiations of their
bodies of its own (``*_mma_kernel_d192`` in bf16, the FMA bodies sized
for 192 in fp32).

Every wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain version on a CPU or ``meta`` tensor (:data:`PLAIN_DEVICES`),
never on the card.  Wrapper and plain version both report the kernel's
closed-form cost (``kernels/cost.py``) to an active cost counter,
whichever of the two runs, with every column of the cache counted
valid.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.chunked import chunked_attention

#: widest head the CUDA kernels take (csrc/common.cuh kMaxD), but for
#: fused_attention_masked's wide body and the training attention
MAX_HEAD_DIM = 128
#: widest Q/K and V heads of the training attention (fused_attention_fwd,
#: _bwd_dq, _bwd_dkv; csrc/common.cuh kTrainMaxD, kTrainMaxDv): MLA's
#: cache-free heads, D = nope 128 + rope 64, Dv 128
TRAIN_MAX_D, TRAIN_MAX_DV = 192, 128
#: widest K and V heads of fused_attention_masked's wide body, which runs
#: past MAX_HEAD_DIM: MLA's absorbed form (csrc/masked_wide.cuh kMaxD,
#: kMaxDv); it reads V as the first Dv columns of K's rows
WIDE_MAX_D, WIDE_MAX_DV = 576, 512
#: keys per tile of the wide body, and its query rows per block: 64 on
#: the tensor cores in bf16, 16 on FMAs in fp32
WIDE_TILE = 32
WIDE_ROWS = {torch.bfloat16: 64, torch.float32: 16}
#: query rows per block and keys per tile of the masked and paged
#: kernels' fp32 one-pass body and their split-KV body (csrc/common.cuh
#: kRows, kTileK)
ROWS, TILE = 16, 64
#: query rows per block of their bf16 one-pass body on the tensor cores
#: (csrc/masked_mma.cuh masked_mma::kRows)
MMA_ROWS = 64
#: the devices whose tensors take a kernel's plain version: the CPU, and
#: the meta device, which computes shapes alone (the dry-run's count)
PLAIN_DEVICES = ("cpu", "meta")


def on_plain_device(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version."""
    return t.device.type in PLAIN_DEVICES


def one_pass_rows(dtype: torch.dtype) -> int:
    """Query rows per block of the one-pass body that runs in ``dtype``:
    the tensor-core body in bf16, the FMA body otherwise."""
    return MMA_ROWS if dtype == torch.bfloat16 else ROWS


def one_pass_blocks(b: int, hq: int, hkv: int, sq: int,
                    rows: int = ROWS) -> int:
    """Blocks of a grid of ``rows``-row tiles over the group * Sq rows of
    each (batch row, KV head): the one-pass bodies' grids and (at ROWS)
    the split-KV body's row tiles."""
    return -(-(hq // hkv) * sq // rows) * b * hkv


def split_chunks(b: int, hq: int, hkv: int, sq: int, n_sms: int,
                 dtype: torch.dtype = torch.bfloat16) -> int:
    """KV chunks per (row tile, batch row, KV head) of the masked and
    paged kernels' split-KV decode body, or 0 for their one-pass body.
    Where the one-pass grid that would launch in ``dtype`` (64-row tiles
    in bf16, 16-row in fp32) has fewer blocks than the card's ``n_sms``
    SMs, each of the split body's 16-row tiles cuts its KV prefix into
    floor(2 * n_sms / its blocks) chunks: at most two blocks per SM (as
    many as fit one, at the split body's shared memory), so one wave;
    where that gives fewer than two chunks the split gains nothing and
    the one-pass body runs.  It reads the shapes and the dtype alone,
    which the dense and the paged kernel share, so the two split
    alike."""
    if one_pass_blocks(b, hq, hkv, sq, one_pass_rows(dtype)) >= n_sms:
        return 0
    n = 2 * n_sms // one_pass_blocks(b, hq, hkv, sq)
    return n if n >= 2 else 0


def chunk_bounds(length: int, n_chunks: int, tile: int = TILE) -> list:
    """The key ranges [start, end) that the split body's chunks of one
    row cover, in chunk order, as ``csrc/fused_attention.cu``
    ``split_kernel`` (``tile`` = TILE) and the wide body
    (``csrc/masked_wide.cuh``, ``tile`` = WIDE_TILE) cut them: the row's
    ceil(length / tile) tiles in chunks of ceil(tiles / n_chunks) whole
    tiles, the last one ending at ``length``.  A length-0 row has
    none."""
    tiles = -(-length // tile)
    if tiles == 0:
        return []
    per = -(-tiles // n_chunks)
    return [(t * tile, min(length, (t + per) * tile))
            for t in range(0, tiles, per)]


def wide_chunks(b: int, hq: int, hkv: int, sq: int, n_sms: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """KV chunks per row tile of the wide body: 1 (one pass, no
    partials) where its grid of row tiles (WIDE_ROWS[dtype] rows each)
    has at least the card's ``n_sms`` blocks, else floor(n_sms / that
    grid): one block fits an SM (its shared memory), so one wave."""
    blocks = one_pass_blocks(b, hq, hkv, sq, WIDE_ROWS[dtype])
    return 1 if blocks >= n_sms else max(1, n_sms // blocks)


def is_column_prefix(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``v`` is the first Dv columns of ``k``'s rows (one
    storage, one start, ``k``'s strides): MLA's V, a view of its latent
    cache, which the wide body reads from K's tile."""
    return (v.data_ptr() == k.data_ptr() and v.dtype == k.dtype
            and v.shape[:-1] == k.shape[:-1] and v.stride() == k.stride()
            and v.shape[-1] <= k.shape[-1])


def kv_split(q: torch.Tensor, v: torch.Tensor, n_sms: int) -> int:
    """:func:`split_chunks` of a masked or paged call: q (B, Hq, Sq, D),
    whose dtype the call shares, and its V array, a dense cache (B, Hkv,
    Skv, Dv) or a page pool (num_pages, Hkv, page, Dv), both with Hkv at
    dim 1 and nothing else read."""
    b, hq, sq, _ = q.shape
    return split_chunks(b, hq, v.shape[1], sq, n_sms, q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_plan(q, v):
    """(n_chunks, partials, ticket counters) of a masked or paged launch:
    (0, None, None) for the one-pass body; else the split body's fp32
    partials, (B * Hq * Sq * n_chunks) rows of Dv values then as many
    (m, l) pairs, and one zeroed int32 counter per (row tile, batch
    row, KV head), which the kernel leaves zeroed."""
    n_chunks = kv_split(q, v, _sm_count(q.device.index))
    if not n_chunks:
        return 0, None, None
    b, hq, sq, _ = q.shape
    rows = b * hq * sq * n_chunks
    part = torch.empty(rows * (v.shape[3] + 2), dtype=torch.float32,
                       device=q.device)
    counter = torch.zeros(one_pass_blocks(b, hq, v.shape[1], sq),
                          dtype=torch.int32, device=q.device)
    return n_chunks, part, counter


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda_args(name: str, tensors: dict,
                    lengths: Optional[torch.Tensor], head_dims,
                    limits=None) -> None:
    """The wrappers' shared checks: no input that autograd tracks (a
    kernel's output has no grad_fn, so it would cut the graph silently:
    differentiable calls go through :func:`fused_attention` and
    ``fused_qproj_attention``); every tensor on one CUDA device, of one
    float dtype, contiguous; lengths, where the kernel takes them, (B,)
    int32 on that device; head widths even and each at most its limit in
    ``limits`` (default MAX_HEAD_DIM)."""
    if torch.is_grad_enabled():
        tracked = [k for k, t in tensors.items() if t.requires_grad]
        if tracked:
            raise RuntimeError(
                f"{name}: {tracked} require grad, but this kernel has no "
                "backward and its output would be cut from autograd; "
                "call it under torch.no_grad() or use the training "
                "entry points (fused_attention, fused_qproj_attention)")
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} on {t.device}, expected the "
                             f"CUDA device {first.device}")
        if t.dtype != first.dtype or t.dtype not in build.DTYPE_CODES:
            raise ValueError(f"{name}: {key} dtype {t.dtype}; all inputs "
                             f"must share one of {list(build.DTYPE_CODES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    if lengths is not None and (
            lengths.dtype != torch.int32 or lengths.device != first.device
            or lengths.ndim != 1 or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be a contiguous (B,) "
                         f"int32 tensor on {first.device}")
    for n, most in zip(head_dims, limits or [MAX_HEAD_DIM] * len(head_dims)):
        if n > most or n % 2:
            raise ValueError(f"{name}: head width {n} must be even and at "
                             f"most {most}")


def check_block_tables(name: str, block_tables: torch.Tensor, b: int,
                       pool: torch.Tensor) -> tuple:
    """The paged wrappers' checks of the table and the pool: a
    contiguous (B, max_pages) int32 table on the pool's device, and a
    page size the paged kernels take (a multiple of 8).  Returns
    (max_pages, page)."""
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != b \
            or block_tables.device != pool.device \
            or not block_tables.is_contiguous():
        raise ValueError(f"{name}: block_tables must be a contiguous "
                         f"({b}, max_pages) int32 tensor on {pool.device}, "
                         f"got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)} on "
                         f"{block_tables.device}")
    page = pool.shape[2]
    if page % 8 or page < 8:
        raise ValueError(f"{name}: page size {page} is not a multiple of 8")
    return block_tables.shape[1], page


def _masked_cost_args(q, k, v, lengths, *, causal=True, scale=None):
    """#1's cost arguments (``kernels/cost.py``): the wide body reads V
    from K's rows."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    return (b, hq, hkv, sq, skv, d, dv), dict(
        causal=causal, el=q.element_size(),
        v_in_k=max(d, dv) > MAX_HEAD_DIM)


def _paged_cost_args(q, k_pool, v_pool, lengths, block_tables, *, causal=True,
                     scale=None):
    """#4's cost arguments: the table's depth and every entry of it."""
    b, hq, sq, d = q.shape
    _, hkv, page, dv = v_pool.shape
    pages = block_tables.shape[1]
    return (b, hq, hkv, sq, pages * page, d, dv), dict(
        causal=causal, el=q.element_size(), table=b * pages)


def _train_cost_args(q, k, v, *rest, causal=True, scale=None, q_offset=None):
    """#7-#9's cost arguments."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    return (b, hq, hkv, sq, skv, d, dv), dict(
        causal=causal, el=q.element_size(),
        q_offset=None if q_offset is None else int(q_offset))


@cost.counted("fused_attention_masked", _masked_cost_args)
def fused_attention_masked_plain(q, k, v, lengths, *, causal: bool = True,
                                 scale: Optional[float] = None):
    """The plain version: ``chunked_attention`` with ``lengths`` and the
    per-row causal anchor ``lengths - Sq``."""
    lens = lengths.clamp(0, k.shape[2])
    return chunked_attention(q, k, v, causal=causal, scale=scale,
                             q_offset=lens - q.shape[2], lengths=lens)


@cost.counted("fused_attention_masked", _masked_cost_args)
def fused_attention_masked(q, k, v, lengths, *, causal: bool = True,
                           scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D[v]); lengths: (B,) int32.
    Returns (B, Hq, Sq, Dv) in q's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU or meta tensor takes the
    plain version."""
    if on_plain_device(q):
        return fused_attention_masked_plain(q, k, v, lengths, causal=causal,
                                            scale=scale)
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if k.shape != (b, hkv, skv, d) or lengths.shape != (b,) or hq % hkv:
        raise ValueError(f"fused_attention_masked: shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    if max(d, dv) > MAX_HEAD_DIM:
        return _masked_wide(q, k, v, lengths, causal, scale)
    check_cuda_args("fused_attention_masked", {"q": q, "k": k, "v": v},
                    lengths, (d, dv))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    n_chunks, part, counter = _split_plan(q, v)
    build.launch("fused_attention_masked", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 _ptr(part), _ptr(counter), b, hq, hkv, sq, skv, d, dv,
                 int(causal), n_chunks, float(scale), build.dtype_code(q))
    return out


def _masked_wide(q, k, v, lengths, causal: bool, scale):
    """#1 past MAX_HEAD_DIM on the wide body: D <= WIDE_MAX_D, Dv <=
    min(D, WIDE_MAX_DV), both even, and ``v`` the first Dv columns of
    ``k``'s rows (MLA's latent cache and its view), which the kernel
    reads once, from K's tile; raises on anything else."""
    name = "fused_attention_masked"
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if d > WIDE_MAX_D or dv > min(d, WIDE_MAX_DV) or d % 2 or dv % 2:
        raise ValueError(f"{name}: head widths D={d}, Dv={dv}: the wide "
                         f"body takes even D <= {WIDE_MAX_D} and Dv <= "
                         f"min(D, {WIDE_MAX_DV})")
    if not is_column_prefix(k, v):
        raise ValueError(f"{name}: past head width {MAX_HEAD_DIM} v must "
                         "be the first Dv columns of k's rows (a view of "
                         "k), which the wide body reads from K's tile")
    check_cuda_args(name, {"q": q, "k": k}, lengths, ())
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    n_chunks = wide_chunks(b, hq, hkv, sq, _sm_count(q.device.index),
                           q.dtype)
    part = counter = None
    if n_chunks > 1:
        part = torch.empty(b * hq * sq * n_chunks * (dv + 2),
                           dtype=torch.float32, device=q.device)
        counter = torch.zeros(one_pass_blocks(b, hq, hkv, sq,
                                              WIDE_ROWS[q.dtype]),
                              dtype=torch.int32, device=q.device)
    build.launch(name, q.data_ptr(), k.data_ptr(), k.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), _ptr(part),
                 _ptr(counter), b, hq, hkv, sq, skv, d, dv, int(causal),
                 n_chunks, float(scale), build.dtype_code(q))
    return out


@cost.counted("fused_attention_paged", _paged_cost_args)
def fused_attention_paged_plain(q, k_pool, v_pool, lengths, block_tables, *,
                                causal: bool = True,
                                scale: Optional[float] = None):
    """The plain version: the pool gathered dense through the table,
    then :func:`fused_attention_masked_plain` (whose clamp of lengths to
    ``max_pages * page`` is the TPU kernel's)."""
    return fused_attention_masked_plain(
        q, ref.gather_pages(k_pool, block_tables),
        ref.gather_pages(v_pool, block_tables), lengths, causal=causal,
        scale=scale)


@cost.counted("fused_attention_paged", _paged_cost_args)
def fused_attention_paged(q, k_pool, v_pool, lengths, block_tables, *,
                          causal: bool = True,
                          scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k_pool, v_pool: (num_pages, Hkv, page, D[v]);
    lengths: (B,) int32; block_tables: (B, max_pages) int32 page ids.
    Returns (B, Hq, Sq, Dv) in q's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU or meta tensor takes the
    plain version."""
    if on_plain_device(q):
        return fused_attention_paged_plain(q, k_pool, v_pool, lengths,
                                           block_tables, causal=causal,
                                           scale=scale)
    b, hq, sq, d = q.shape
    n_pages, hkv, page, dv = v_pool.shape
    if k_pool.shape != (n_pages, hkv, page, d) or lengths.shape != (b,) \
            or hq % hkv:
        raise ValueError(f"fused_attention_paged: shapes q{tuple(q.shape)} "
                         f"k_pool{tuple(k_pool.shape)} "
                         f"v_pool{tuple(v_pool.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_attention_paged",
                    {"q": q, "k_pool": k_pool, "v_pool": v_pool}, lengths,
                    (d, dv))
    max_pages, page = check_block_tables("fused_attention_paged",
                                         block_tables, b, k_pool)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    n_chunks, part, counter = _split_plan(q, v_pool)
    build.launch("fused_attention_paged", q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), lengths.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), _ptr(part),
                 _ptr(counter), b, hq, hkv, sq, max_pages, page, d, dv,
                 int(causal), n_chunks, float(scale), build.dtype_code(q))
    return out


# ---------------------------------------------------------------------------
# the training attention: fused_attention_fwd (#7), its backward
# fused_attention_bwd_dq (#8) and fused_attention_bwd_dkv (#9)
# ---------------------------------------------------------------------------

fused_attention_fwd_plain = cost.counted(
    "fused_attention_fwd", _train_cost_args)(ref.attention_fwd_plain)
fused_attention_bwd_dq_plain = cost.counted(
    "fused_attention_bwd_dq", _train_cost_args)(ref.attention_bwd_dq_plain)
fused_attention_bwd_dkv_plain = cost.counted(
    "fused_attention_bwd_dkv", _train_cost_args)(ref.attention_bwd_dkv_plain)


def _train_shapes(name: str, q, k, v):
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if k.shape != (b, hkv, skv, d) or hq % hkv:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    return b, hq, hkv, sq, skv, d, dv


def _check_rows(name: str, shape, **fp32) -> None:
    """lse and delta: contiguous fp32 (B, Hq, Sq) on the inputs' card."""
    for key, t in fp32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous fp32 "
                             f"{shape} tensor on the card, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def causal_anchor(q_offset, sq: int, skv: int) -> int:
    """The global position of query row 0: ``q_offset``, default
    Skv - Sq."""
    return (skv - sq) if q_offset is None else int(q_offset)


@cost.counted("fused_attention_fwd", _train_cost_args)
def fused_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None, q_offset=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D[v]).  Returns (o, lse):
    o (B, Hq, Sq, Dv) in q's dtype, lse (B, Hq, Sq) fp32.  Causal rows
    are anchored at ``q_offset + r`` (default Skv - Sq).  On a CUDA
    tensor this launches the kernel (or raises); a CPU or meta tensor
    takes the plain version."""
    if on_plain_device(q):
        return fused_attention_fwd_plain(q, k, v, causal=causal,
                                         scale=scale, q_offset=q_offset)
    b, hq, hkv, sq, skv, d, dv = _train_shapes("fused_attention_fwd",
                                               q, k, v)
    check_cuda_args("fused_attention_fwd", {"q": q, "k": k, "v": v}, None,
                    (d, dv), (TRAIN_MAX_D, TRAIN_MAX_DV))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    build.launch("fused_attention_fwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq, hkv,
                 sq, skv, d, dv, int(causal), causal_anchor(q_offset, sq, skv),
                 float(scale), build.dtype_code(q))
    return out, lse


def _bwd_args(name, q, k, v, do, lse, delta):
    b, hq, hkv, sq, skv, d, dv = _train_shapes(name, q, k, v)
    if do.shape != (b, hq, sq, dv):
        raise ValueError(f"{name}: do{tuple(do.shape)} is not "
                         f"{(b, hq, sq, dv)}")
    check_cuda_args(name, {"q": q, "k": k, "v": v, "do": do}, None, (d, dv),
                    (TRAIN_MAX_D, TRAIN_MAX_DV))
    _check_rows(name, (b, hq, sq), lse=lse, delta=delta)
    return b, hq, hkv, sq, skv, d, dv


@cost.counted("fused_attention_bwd_dq", _train_cost_args)
def fused_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           scale: Optional[float] = None, q_offset=None):
    """dq (B, Hq, Sq, D) in q's dtype from the forward's inputs, the
    cotangent ``do``, the forward's ``lse`` and ``delta =
    ref.attention_delta(o, do)``.  On a CUDA tensor this launches the
    kernel (or raises); a CPU or meta tensor takes the plain version."""
    if on_plain_device(q):
        return fused_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal, scale=scale,
                                            q_offset=q_offset)
    b, hq, hkv, sq, skv, d, dv = _bwd_args("fused_attention_bwd_dq", q, k,
                                           v, do, lse, delta)
    scale = scale if scale is not None else d ** -0.5
    dq = torch.empty_like(q)
    build.launch("fused_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), b, hq, hkv, sq, skv, d, dv,
                 int(causal), causal_anchor(q_offset, sq, skv), float(scale),
                 build.dtype_code(q))
    return dq


@cost.counted("fused_attention_bwd_dkv", _train_cost_args)
def fused_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            scale: Optional[float] = None, q_offset=None):
    """(dk, dv), each summed over its GQA group, in k's and v's dtype.
    Arguments as :func:`fused_attention_bwd_dq`.  On a CUDA tensor this
    launches the kernel (or raises); a CPU or meta tensor takes the
    plain version."""
    if on_plain_device(q):
        return fused_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal=causal, scale=scale,
                                             q_offset=q_offset)
    b, hq, hkv, sq, skv, d, dv = _bwd_args("fused_attention_bwd_dkv", q, k,
                                           v, do, lse, delta)
    scale = scale if scale is not None else d ** -0.5
    dk, dvv = torch.empty_like(k), torch.empty_like(v)
    build.launch("fused_attention_bwd_dkv", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, hq, hkv,
                 sq, skv, d, dv, int(causal), causal_anchor(q_offset, sq, skv),
                 float(scale), build.dtype_code(q))
    return dk, dvv


def attention_backward(q, k, v, o, lse, do, *, causal, scale, q_offset,
                       plain: bool):
    """(dq, dk, dv) through the two backward kernels (or, ``plain``,
    their plain versions): delta, then dq, then dk/dv."""
    do = do.contiguous()
    delta = ref.attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    if plain:
        return (fused_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
                *fused_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    return (fused_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
            *fused_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))


class _FusedAttention(torch.autograd.Function):
    """Forward #7 saving (q, k, v, o, lse); backward #8 then #9."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = fused_attention_fwd_plain if plain else fused_attention_fwd
        o, lse = fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        plain=plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None


def fused_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, q_offset=None,
                    plain: bool = False):
    """Differentiable layer-fused attention (Fig. 5c) over the whole
    sequence: q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D[v]); causal rows
    anchored at ``q_offset + r`` (default Skv - Sq).  The forward runs
    ``fused_attention_fwd`` and keeps its lse; the backward runs
    ``fused_attention_bwd_dq`` and ``fused_attention_bwd_dkv``.  Each
    wrapper launches its kernel on a CUDA tensor and runs its plain
    version on a CPU or meta one; ``plain`` runs the plain versions on
    the card too."""
    return _FusedAttention.apply(q, k, v, causal, scale, q_offset, plain)
