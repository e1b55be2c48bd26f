"""``fused_decode_block``: the whole M=1 attention sub-block in one
launch (Q projection + RoPE, masked softmax over the prefix, P.V, the
output projection summed over heads, and the residual), as a CUDA
kernel for Hopper (``csrc/fused_decode_block.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_decode_block.py``
``fused_decode_block``.  The heads' contributions are summed in head
order in fp32, deterministically, as the TPU kernel sums them.
``fused_decode_block_paged`` (replacing the TPU kernel of that name) is
the same sub-block over a KV page pool read through block tables.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import (check_block_tables,
                                                 check_cuda_args)


def _workspace(b: int, hq: int, e: int, device):
    """Per-(row, head) fp32 partials and the per-row ticket counters of
    the kernel's deterministic head reduction."""
    return (torch.empty((b, hq, e), dtype=torch.float32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device))


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


def fused_decode_block(x, wq, k, v, wo, residual, lengths, *,
                       scale: Optional[float] = None,
                       rope_theta: Optional[float] = None):
    """x, residual: (B, 1, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]);
    wo: (Hq, Dv, E); lengths: (B,) int32.  Returns (B, 1, E) =
    ``residual + attn_out @ Wo``.  On a CUDA tensor this launches the
    kernel (or raises); a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
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
    partial, counter = _workspace(b, hq, e, x.device)
    build.launch("fused_decode_block", x.data_ptr(), wq.data_ptr(),
                 k.data_ptr(), v.data_ptr(), wo.data_ptr(),
                 residual.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 partial.data_ptr(), counter.data_ptr(), b, hq, hkv, skv,
                 e, d, dv, float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x))
    return out


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


def fused_decode_block_paged(x, wq, k_pool, v_pool, wo, residual, lengths,
                             block_tables, *, scale: Optional[float] = None,
                             rope_theta: Optional[float] = None):
    """x, residual: (B, 1, E); wq: (E, Hq, D); k_pool, v_pool:
    (num_pages, Hkv, page, D[v]); wo: (Hq, Dv, E); lengths: (B,) int32;
    block_tables: (B, max_pages) int32.  Returns (B, 1, E) =
    ``residual + attn_out @ Wo``.  On a CUDA tensor this launches the
    kernel (or raises); a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
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
    partial, counter = _workspace(b, hq, e, x.device)
    build.launch("fused_decode_block_paged", x.data_ptr(), wq.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), wo.data_ptr(),
                 residual.data_ptr(), lengths.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), partial.data_ptr(),
                 counter.data_ptr(), b, hq, hkv, max_pages, page, e, d, dv,
                 float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x))
    return out
