"""``fused_qproj_attention_masked``: the paper's Fig. 5b schedule over a
KV cache (Q = x @ Wq built inside the attention kernel, never stored),
as a CUDA kernel for Hopper (``csrc/fused_qproj_attention.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_qproj_attention.py``
``fused_qproj_attention_masked``.  The Q tile is projected in fp32,
rotated by RoPE at ``lengths[b] - Sq + r`` when ``rope_theta`` is set,
rounded to K's dtype, then runs ``fused_attention_masked``'s body.
``fused_qproj_attention_paged`` (replacing the TPU kernel of that name)
is the same over a KV page pool read through block tables.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import (check_block_tables,
                                                 check_cuda_args)


def fused_qproj_attention_masked_plain(x, wq, k, v, lengths, *,
                                       causal: bool = True,
                                       scale: Optional[float] = None,
                                       rope_theta: Optional[float] = None):
    """The plain version (``repro/kernels/ops.py:441-449``): Q by
    einsum, RoPE at ``rope_positions(lengths=...)``, then chunked
    attention with the per-row anchor."""
    sq = x.shape[1]
    lens = lengths.clamp(0, k.shape[2])
    q = torch.einsum("bse,ehd->bhsd", x, wq.to(x.dtype))
    if rope_theta is not None:
        q = ref.rope(q, ref.rope_positions(sq, k.shape[2], lengths=lens),
                     rope_theta)
    return chunked_attention(q, k, v, causal=causal, scale=scale,
                             q_offset=lens - sq, lengths=lens)


def fused_qproj_attention_masked(x, wq, k, v, lengths, *,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 rope_theta: Optional[float] = None):
    """x: (B, Sq, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]);
    lengths: (B,) int32.  Returns (B, Hq, Sq, Dv) in x's dtype.  On a
    CUDA tensor this launches the kernel (or raises); a CPU tensor takes
    the plain version."""
    if x.device.type == "cpu":
        return fused_qproj_attention_masked_plain(
            x, wq, k, v, lengths, causal=causal, scale=scale,
            rope_theta=rope_theta)
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    if wq.shape[0] != e or k.shape != (b, hkv, skv, d) \
            or lengths.shape != (b,) or hq % hkv:
        raise ValueError(
            f"fused_qproj_attention_masked: shapes x{tuple(x.shape)} "
            f"wq{tuple(wq.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
            f"lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_qproj_attention_masked",
                    {"x": x, "wq": wq, "k": k, "v": v}, lengths, (d, dv))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=x.dtype, device=x.device)
    build.launch("fused_qproj_attention_masked", x.data_ptr(),
                 wq.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv,
                 e, d, dv, int(causal), float(scale),
                 float(rope_theta or 0.0), int(rope_theta is not None),
                 build.dtype_code(x))
    return out


def fused_qproj_attention_paged_plain(x, wq, k_pool, v_pool, lengths,
                                      block_tables, *, causal: bool = True,
                                      scale: Optional[float] = None,
                                      rope_theta: Optional[float] = None):
    """The plain version: the pool gathered dense through the table,
    then :func:`fused_qproj_attention_masked_plain`."""
    return fused_qproj_attention_masked_plain(
        x, wq, ref.gather_pages(k_pool, block_tables),
        ref.gather_pages(v_pool, block_tables), lengths, causal=causal,
        scale=scale, rope_theta=rope_theta)


def fused_qproj_attention_paged(x, wq, k_pool, v_pool, lengths,
                                block_tables, *, causal: bool = True,
                                scale: Optional[float] = None,
                                rope_theta: Optional[float] = None):
    """x: (B, Sq, E); wq: (E, Hq, D); k_pool, v_pool: (num_pages, Hkv,
    page, D[v]); lengths: (B,) int32; block_tables: (B, max_pages)
    int32.  Returns (B, Hq, Sq, Dv) in x's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return fused_qproj_attention_paged_plain(
            x, wq, k_pool, v_pool, lengths, block_tables, causal=causal,
            scale=scale, rope_theta=rope_theta)
    b, sq, e = x.shape
    _, hq, d = wq.shape
    n_pages, hkv, page, dv = v_pool.shape
    if wq.shape[0] != e or k_pool.shape != (n_pages, hkv, page, d) \
            or lengths.shape != (b,) or hq % hkv:
        raise ValueError(
            f"fused_qproj_attention_paged: shapes x{tuple(x.shape)} "
            f"wq{tuple(wq.shape)} k_pool{tuple(k_pool.shape)} "
            f"v_pool{tuple(v_pool.shape)} lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_qproj_attention_paged",
                    {"x": x, "wq": wq, "k_pool": k_pool, "v_pool": v_pool},
                    lengths, (d, dv))
    max_pages, page = check_block_tables("fused_qproj_attention_paged",
                                         block_tables, b, k_pool)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=x.dtype, device=x.device)
    build.launch("fused_qproj_attention_paged", x.data_ptr(), wq.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), lengths.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), b, hq, hkv, sq,
                 max_pages, page, e, d, dv, int(causal), float(scale),
                 float(rope_theta or 0.0), int(rope_theta is not None),
                 build.dtype_code(x))
    return out
