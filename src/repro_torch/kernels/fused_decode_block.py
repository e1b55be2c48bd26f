"""``fused_decode_block``: the whole M=1 attention sub-block in one
launch (Q projection + RoPE, masked softmax over the prefix, P.V, the
output projection summed over heads, and the residual), as a CUDA
kernel for Hopper (``csrc/fused_decode_block.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_decode_block.py``
``fused_decode_block``.  Every sum has a fixed order, so the result is
bitwise repeatable.  ``fused_decode_block_paged`` (replacing the TPU
kernel of that name) is the same sub-block over a KV page pool read
through block tables.

In bf16 the kernel is one cooperative launch of a block per SM that
reads Wq and Wo once (the notes of the ``.cu`` file); :func:`decode_plan`
is its work partition and workspace layout, a function of the shapes
and the SM count alone.  The workspace is kept per (device, stream,
shapes), so a launch allocates nothing and clears nothing: its tickets
start at zero and each launch leaves them at zero, and its grid
barrier's count of arrivals only counts up.  fp32 runs the FMA body,
whose workspace is kept the same way.  Setting :data:`PHASE_TRACE`
makes each bf16 launch stamp its blocks' phases (``time_decode_block.py``).

As in ``fused_attention``, a CPU or meta tensor takes the plain
version, and wrapper and plain version report the kernel's closed-form
cost to an active cost counter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import (_sm_count,
                                                 check_block_tables,
                                                 check_cuda_args,
                                                 on_plain_device)

#: the bf16 body's geometry (csrc/fused_decode_block.cu, namespace mk)
UNIT_ROWS = 64    # weight rows (Wq's E, Wo's Hq * Dv) per unit
OUT_TILE = 128    # Wo columns (E) per unit
ROW_GROUP = 32    # batch rows per pass over a block's run
ROW_TILE = 16     # query rows of one attention item
KEY_TILE = 64     # keys per tile of an item's chunk


def _up256(n: int) -> int:
    return -(-n // 256) * 256


def unit_range(blk: int, units: int, n_blocks: int) -> tuple:
    """The units [lo, hi) of block ``blk``'s run (``Part::lo``)."""
    return blk * units // n_blocks, (blk + 1) * units // n_blocks


def owner(u: int, units: int, n_blocks: int) -> int:
    """The block whose run holds unit ``u`` (``Part::owner``)."""
    return ((u + 1) * n_blocks - 1) // units


def slots(units: int, n_blocks: int, per_tile: int) -> int:
    """Partial slots per column tile (``Part::slots``): a bound on
    owner(last unit of a tile) - owner(first) + 1."""
    return min(n_blocks, (per_tile - 1) * n_blocks // units + 2)


class DecodePlan(NamedTuple):
    """The bf16 body's partition for one shape on ``n_blocks`` SMs.
    Phase (a): ``units_a`` units of UNIT_ROWS rows of Wq by one head's D
    columns, ``per_a`` to a head.  Phase (b): B * Hkv * ``n_rt`` row
    tiles of ROW_TILE query rows, each cut into ``n_chunks`` key chunks.
    Phase (c): ``units_c`` units of UNIT_ROWS rows of Wo by OUT_TILE
    columns, ``per_c`` to one of ``tiles_c`` column tiles.  Both weights'
    units go to the blocks in contiguous runs (:func:`unit_range`)."""
    n_blocks: int
    n_chunks: int
    n_rt: int
    units_a: int
    per_a: int
    slots_a: int
    units_c: int
    per_c: int
    tiles_c: int
    slots_c: int
    counter_bytes: int
    workspace_bytes: int


def decode_plan(b: int, hq: int, hkv: int, e: int, d: int, dv: int,
                n_blocks: int) -> DecodePlan:
    """The bf16 body's partition and workspace size (``mk::layout``):
    the counters (grid barrier, merge tickets, output-tile tickets;
    ``counter_bytes`` in all), then q's partials, the attention chunks'
    partials, O and the output tiles' partials, each region at a
    256-byte boundary."""
    group = hq // hkv
    n_rt = -(-group // ROW_TILE)
    n_chunks = max(1, n_blocks // (b * hkv * n_rt))
    per_a = -(-e // UNIT_ROWS)
    per_c = -(-(hq * dv) // UNIT_ROWS)
    tiles_c = -(-e // OUT_TILE)
    units_a, units_c = hq * per_a, tiles_c * per_c
    slots_a = slots(units_a, n_blocks, per_a)
    slots_c = slots(units_c, n_blocks, per_c)
    items = b * hkv * n_rt * n_chunks
    n_rg = -(-b // ROW_GROUP)
    counters = 0
    for region in (8, 4 * b * hkv * n_rt, 4 * n_rg * tiles_c):
        counters = _up256(counters + region)
    size = counters
    for region in (4 * hq * slots_a * b * d, 4 * items * ROW_TILE * dv,
                   8 * items * ROW_TILE, 2 * b * hq * dv,
                   4 * tiles_c * slots_c * b * OUT_TILE):
        size = _up256(size + region)
    return DecodePlan(n_blocks, n_chunks, n_rt, units_a, per_a, slots_a,
                      units_c, per_c, tiles_c, slots_c, counters, size)


def _fma_bytes(b: int, hq: int, e: int) -> int:
    """The fp32 body's workspace: (B, Hq, E) fp32 partials, then B
    ticket counters (``fma_launch``)."""
    return _up256(4 * b * hq * e) + 4 * b


#: (device, stream, dtype, shapes) -> the workspace of that launch
_WORKSPACES: dict = {}

#: stamps of a traced bf16 launch (``mk::stamp``): the start, the end of
#: phase (a), past barrier (a); in the block's first attention item, q
#: ready, its tiles done, its ticket drawn (0 where it has none); the end
#: of phase (b), past barrier (b), the end
STAMPS = 9
#: None, or a contiguous int64 CUDA tensor of (STAMPS, n_blocks): while
#: it is set, each bf16 launch writes every block's globaltimer (ns) at
#: each stamp into it (time_decode_block.py reads the phases from it)
PHASE_TRACE: Optional[torch.Tensor] = None


def _trace_ptr(device, n_blocks: int) -> Optional[int]:
    t = PHASE_TRACE
    if t is None or not n_blocks:
        return None
    if t.dtype != torch.int64 or t.shape != (STAMPS, n_blocks) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"PHASE_TRACE must be a contiguous int64 "
                         f"({STAMPS}, {n_blocks}) tensor on {device}")
    return t.data_ptr()


def _workspace(x, key: tuple, nbytes: int) -> torch.Tensor:
    """The launch's workspace, zeroed once when first made.  Keyed by the
    current stream too, so launches on two streams never share one."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
           x.dtype) + key
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
        _WORKSPACES[key] = ws
    return ws


def _launch_plan(x, b, hq, hkv, e, d, dv):
    """(workspace, n_blocks, n_chunks) of a launch in x's dtype."""
    if x.dtype == torch.float32:
        return _workspace(x, ("fma", b, hq, e), _fma_bytes(b, hq, e)), 0, 0
    plan = decode_plan(b, hq, hkv, e, d, dv, _sm_count(x.device.index))
    ws = _workspace(x, ("mma", b, hq, hkv, e, d, dv, plan.n_blocks),
                    plan.workspace_bytes)
    return ws, plan.n_blocks, plan.n_chunks


def _decode_cost_args(x, wq, k, v, wo, residual, lengths, *, scale=None,
                      rope_theta=None):
    """#3's cost arguments (``kernels/cost.py``)."""
    b, _, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    return (b, e, hq, hkv, skv, d, dv), dict(el=x.element_size())


def _paged_cost_args(x, wq, k_pool, v_pool, wo, residual, lengths,
                     block_tables, *, scale=None, rope_theta=None):
    """#6's cost arguments: the table's depth and every entry of it."""
    b, _, e = x.shape
    _, hq, d = wq.shape
    _, hkv, page, dv = v_pool.shape
    pages = block_tables.shape[1]
    return (b, e, hq, hkv, pages * page, d, dv), dict(
        el=x.element_size(), table=b * pages)


@cost.counted("fused_decode_block", _decode_cost_args)
def fused_decode_block_plain(x, wq, k, v, wo, residual, lengths, *,
                             scale: Optional[float] = None,
                             rope_theta: Optional[float] = None):
    """The plain version (``repro/kernels/ops.py:528-537``)."""
    lens = lengths.clamp(0, k.shape[2])
    q = torch.einsum("bse,ehd->bhsd", x, wq.to(x.dtype))
    if rope_theta is not None:
        q = ref.rope(q, ref.rope_positions(1, k.shape[2], lengths=lens),
                     rope_theta)
    o = chunked_attention(q, k, v, causal=False, scale=scale, lengths=lens)
    y = torch.einsum("bhse,hed->bsd", o.to(wo.dtype).float(), wo.float())
    return (residual.float() + y).to(x.dtype)


@cost.counted("fused_decode_block", _decode_cost_args)
def fused_decode_block(x, wq, k, v, wo, residual, lengths, *,
                       scale: Optional[float] = None,
                       rope_theta: Optional[float] = None):
    """x, residual: (B, 1, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]);
    wo: (Hq, Dv, E); lengths: (B,) int32.  Returns (B, 1, E) =
    ``residual + attn_out @ Wo``.  On a CUDA tensor this launches the
    kernel (or raises); a CPU or meta tensor takes the plain version."""
    if on_plain_device(x):
        return fused_decode_block_plain(x, wq, k, v, wo, residual, lengths,
                                        scale=scale, rope_theta=rope_theta)
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    if sq != 1 or wq.shape[0] != e or k.shape != (b, hkv, skv, d) \
            or wo.shape != (hq, dv, e) or residual.shape != x.shape \
            or lengths.shape != (b,) or hq % hkv:
        raise ValueError(
            f"fused_decode_block: shapes x{tuple(x.shape)} "
            f"wq{tuple(wq.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
            f"wo{tuple(wo.shape)} residual{tuple(residual.shape)} "
            f"lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_decode_block",
                    {"x": x, "wq": wq, "k": k, "v": v, "wo": wo,
                     "residual": residual}, lengths, (d, dv))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(x)
    ws, n_blocks, n_chunks = _launch_plan(x, b, hq, hkv, e, d, dv)
    build.launch("fused_decode_block", x.data_ptr(), wq.data_ptr(),
                 k.data_ptr(), v.data_ptr(), wo.data_ptr(),
                 residual.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), ws.numel(), b, hq, hkv, skv, e, d, dv,
                 float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x), n_blocks,
                 n_chunks, _trace_ptr(x.device, n_blocks))
    return out


@cost.counted("fused_decode_block_paged", _paged_cost_args)
def fused_decode_block_paged_plain(x, wq, k_pool, v_pool, wo, residual,
                                   lengths, block_tables, *,
                                   scale: Optional[float] = None,
                                   rope_theta: Optional[float] = None):
    """The plain version: the pool gathered dense through the table,
    then :func:`fused_decode_block_plain`."""
    return fused_decode_block_plain(
        x, wq, ref.gather_pages(k_pool, block_tables),
        ref.gather_pages(v_pool, block_tables), wo, residual, lengths,
        scale=scale, rope_theta=rope_theta)


@cost.counted("fused_decode_block_paged", _paged_cost_args)
def fused_decode_block_paged(x, wq, k_pool, v_pool, wo, residual, lengths,
                             block_tables, *, scale: Optional[float] = None,
                             rope_theta: Optional[float] = None):
    """x, residual: (B, 1, E); wq: (E, Hq, D); k_pool, v_pool:
    (num_pages, Hkv, page, D[v]); wo: (Hq, Dv, E); lengths: (B,) int32;
    block_tables: (B, max_pages) int32.  Returns (B, 1, E) =
    ``residual + attn_out @ Wo``.  On a CUDA tensor this launches the
    kernel (or raises); a CPU or meta tensor takes the plain version."""
    if on_plain_device(x):
        return fused_decode_block_paged_plain(
            x, wq, k_pool, v_pool, wo, residual, lengths, block_tables,
            scale=scale, rope_theta=rope_theta)
    b, sq, e = x.shape
    _, hq, d = wq.shape
    n_pages, hkv, page, dv = v_pool.shape
    if sq != 1 or wq.shape[0] != e \
            or k_pool.shape != (n_pages, hkv, page, d) \
            or wo.shape != (hq, dv, e) or residual.shape != x.shape \
            or lengths.shape != (b,) or hq % hkv:
        raise ValueError(
            f"fused_decode_block_paged: shapes x{tuple(x.shape)} "
            f"wq{tuple(wq.shape)} k_pool{tuple(k_pool.shape)} "
            f"v_pool{tuple(v_pool.shape)} wo{tuple(wo.shape)} "
            f"residual{tuple(residual.shape)} "
            f"lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_decode_block_paged",
                    {"x": x, "wq": wq, "k_pool": k_pool, "v_pool": v_pool,
                     "wo": wo, "residual": residual}, lengths, (d, dv))
    max_pages, page = check_block_tables("fused_decode_block_paged",
                                         block_tables, b, k_pool)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(x)
    ws, n_blocks, n_chunks = _launch_plan(x, b, hq, hkv, e, d, dv)
    build.launch("fused_decode_block_paged", x.data_ptr(), wq.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), wo.data_ptr(),
                 residual.data_ptr(), lengths.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 ws.numel(), b, hq, hkv, max_pages, page, e, d, dv,
                 float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x), n_blocks,
                 n_chunks, _trace_ptr(x.device, n_blocks))
    return out
