"""``fused_attention_masked``: masked-lengths layer-fused attention (the
paper's Fig. 5c schedule over a KV cache), and ``fused_attention_paged``,
the same over a KV page pool, as CUDA kernels for Hopper
(``csrc/fused_attention.cu``) with their plain PyTorch versions.

Replace the TPU kernels ``repro/kernels/fused_attention.py``
``fused_attention_masked`` and ``fused_attention_paged``.  Row r of
batch row b attends columns ``c < lengths[b]`` and, under ``causal``,
``c <= lengths[b] - Sq + r`` (the causal triangle anchored at the end
of the valid prefix); rows with no valid column emit zeros.  The paged
kernel reads logical KV block j of row b from pool page
``block_tables[b, j]``; the math is the masked kernel's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.chunked import chunked_attention

#: widest head the CUDA kernels take (csrc/common.cuh kMaxD)
MAX_HEAD_DIM = 128


def check_cuda_args(name: str, tensors: dict, lengths: torch.Tensor,
                    head_dims) -> None:
    """The wrappers' shared checks: every tensor on one CUDA device, of
    one float dtype, contiguous; lengths (B,) int32 on that device; head
    widths even and at most MAX_HEAD_DIM."""
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
    if lengths.dtype != torch.int32 or lengths.device != first.device \
            or lengths.ndim != 1 or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be a contiguous (B,) "
                         f"int32 tensor on {first.device}")
    for n in head_dims:
        if n > MAX_HEAD_DIM or n % 2:
            raise ValueError(f"{name}: head width {n} must be even and at "
                             f"most {MAX_HEAD_DIM}")


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


def fused_attention_masked_plain(q, k, v, lengths, *, causal: bool = True,
                                 scale: Optional[float] = None):
    """The plain version: ``chunked_attention`` with ``lengths`` and the
    per-row causal anchor ``lengths - Sq``."""
    lens = lengths.clamp(0, k.shape[2])
    return chunked_attention(q, k, v, causal=causal, scale=scale,
                             q_offset=lens - q.shape[2], lengths=lens)


def fused_attention_masked(q, k, v, lengths, *, causal: bool = True,
                           scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D[v]); lengths: (B,) int32.
    Returns (B, Hq, Sq, Dv) in q's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return fused_attention_masked_plain(q, k, v, lengths, causal=causal,
                                            scale=scale)
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if k.shape != (b, hkv, skv, d) or lengths.shape != (b,) or hq % hkv:
        raise ValueError(f"fused_attention_masked: shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    check_cuda_args("fused_attention_masked", {"q": q, "k": k, "v": v},
                    lengths, (d, dv))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    build.launch("fused_attention_masked", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, skv, d, dv, int(causal), float(scale),
                  build.dtype_code(q))
    return out


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


def fused_attention_paged(q, k_pool, v_pool, lengths, block_tables, *,
                          causal: bool = True,
                          scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k_pool, v_pool: (num_pages, Hkv, page, D[v]);
    lengths: (B,) int32; block_tables: (B, max_pages) int32 page ids.
    Returns (B, Hq, Sq, Dv) in q's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
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
    build.launch("fused_attention_paged", q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), lengths.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), b, hq, hkv, sq,
                 max_pages, page, d, dv, int(causal), float(scale),
                 build.dtype_code(q))
    return out
