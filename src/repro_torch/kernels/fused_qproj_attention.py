"""``fused_qproj_attention_masked``: the paper's Fig. 5b schedule over a
KV cache (Q = x @ Wq built inside the attention kernel, never stored),
as a CUDA kernel for Hopper (``csrc/fused_qproj_attention.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_qproj_attention.py``
``fused_qproj_attention_masked``.  The Q tile is projected with fp32
accumulation (on the tensor cores in bf16), rotated by RoPE at
``lengths[b] - Sq + r`` when ``rope_theta`` is set, rounded to K's
dtype, then runs ``fused_attention_masked``'s body.
``fused_qproj_attention_paged`` (replacing the TPU kernel of that name)
is the same over a KV page pool read through block tables.

``fused_qproj_attention`` is the cache-free, differentiable schedule
(replacing the TPU ``custom_vjp`` ``fused_qproj_attention``): its
forward is the kernel ``fused_qproj_attention_fwd`` (#2's body over the
whole sequence, rows anchored and rotated at ``q_offset + r``, with
lse); its backward recomputes and rotates Q, runs the training
attention's two backward kernels, un-rotates dq and forms dx and dWq as
plain products, as ``_fqa_bwd`` does.

As in ``fused_attention``, a CPU or meta tensor takes the plain
version, and wrapper and plain version report the kernel's closed-form
cost to an active cost counter.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import (
    attention_backward, causal_anchor, check_block_tables, check_cuda_args,
    on_plain_device)


def _masked_cost_args(x, wq, k, v, lengths, *, causal=True, scale=None,
                      rope_theta=None):
    """#2's cost arguments (``kernels/cost.py``)."""
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    return (b, sq, e, hq, hkv, skv, d, dv), dict(causal=causal,
                                                 el=x.element_size())


def _paged_cost_args(x, wq, k_pool, v_pool, lengths, block_tables, *,
                     causal=True, scale=None, rope_theta=None):
    """#5's cost arguments: the table's depth and every entry of it."""
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, page, dv = v_pool.shape
    pages = block_tables.shape[1]
    return (b, sq, e, hq, hkv, pages * page, d, dv), dict(
        causal=causal, el=x.element_size(), table=b * pages)


def _fwd_cost_args(x, wq, k, v, *, causal=True, scale=None, q_offset=None,
                   rope_theta=None):
    """#10's cost arguments."""
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    return (b, sq, e, hq, hkv, skv, d, dv), dict(
        causal=causal, el=x.element_size(),
        q_offset=None if q_offset is None else int(q_offset))


@cost.counted("fused_qproj_attention_masked", _masked_cost_args)
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


@cost.counted("fused_qproj_attention_masked", _masked_cost_args)
def fused_qproj_attention_masked(x, wq, k, v, lengths, *,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 rope_theta: Optional[float] = None):
    """x: (B, Sq, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]);
    lengths: (B,) int32.  Returns (B, Hq, Sq, Dv) in x's dtype.  On a
    CUDA tensor this launches the kernel (or raises); a CPU or meta
    tensor takes the plain version."""
    if on_plain_device(x):
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


@cost.counted("fused_qproj_attention_paged", _paged_cost_args)
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


@cost.counted("fused_qproj_attention_paged", _paged_cost_args)
def fused_qproj_attention_paged(x, wq, k_pool, v_pool, lengths,
                                block_tables, *, causal: bool = True,
                                scale: Optional[float] = None,
                                rope_theta: Optional[float] = None):
    """x: (B, Sq, E); wq: (E, Hq, D); k_pool, v_pool: (num_pages, Hkv,
    page, D[v]); lengths: (B,) int32; block_tables: (B, max_pages)
    int32.  Returns (B, Hq, Sq, Dv) in x's dtype.  On a CUDA tensor this
    launches the kernel (or raises); a CPU or meta tensor takes the
    plain version."""
    if on_plain_device(x):
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


# ---------------------------------------------------------------------------
# the training schedule: fused_qproj_attention_fwd (#10) and its backward
# ---------------------------------------------------------------------------

def _project(x, wq, sq: int, skv: int, q_offset, rope_theta):
    """Q = x @ Wq in x's dtype, rotated at ``q_offset + r`` (default
    Skv - Sq) when ``rope_theta`` is set; returns (q, positions)."""
    q = torch.einsum("bse,ehd->bhsd", x, wq.to(x.dtype))
    if rope_theta is None:
        return q, None
    pos = ref.rope_positions(sq, skv, q_offset=q_offset, device=x.device)
    return ref.rope(q, pos, rope_theta), pos


@cost.counted("fused_qproj_attention_fwd", _fwd_cost_args)
def fused_qproj_attention_fwd_plain(x, wq, k, v, *, causal: bool = True,
                                    scale: Optional[float] = None,
                                    q_offset=None,
                                    rope_theta: Optional[float] = None):
    """The plain version: Q by einsum, RoPE at ``q_offset + r``, then
    ``ref.attention_fwd_plain``.  Returns (o, lse)."""
    q, _ = _project(x, wq, x.shape[1], k.shape[2], q_offset, rope_theta)
    return ref.attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)


@cost.counted("fused_qproj_attention_fwd", _fwd_cost_args)
def fused_qproj_attention_fwd(x, wq, k, v, *, causal: bool = True,
                              scale: Optional[float] = None, q_offset=None,
                              rope_theta: Optional[float] = None):
    """x: (B, Sq, E); wq: (E, Hq, D); k, v: (B, Hkv, Skv, D[v]).
    Returns (o, lse): o (B, Hq, Sq, Dv) in x's dtype, lse (B, Hq, Sq)
    fp32.  Rows are anchored and rotated at ``q_offset + r`` (default
    Skv - Sq).  On a CUDA tensor this launches the kernel (or raises); a
    CPU or meta tensor takes the plain version."""
    if on_plain_device(x):
        return fused_qproj_attention_fwd_plain(
            x, wq, k, v, causal=causal, scale=scale, q_offset=q_offset,
            rope_theta=rope_theta)
    b, sq, e = x.shape
    _, hq, d = wq.shape
    _, hkv, skv, dv = v.shape
    if wq.shape[0] != e or k.shape != (b, hkv, skv, d) or hq % hkv:
        raise ValueError(
            f"fused_qproj_attention_fwd: shapes x{tuple(x.shape)} "
            f"wq{tuple(wq.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    check_cuda_args("fused_qproj_attention_fwd",
                    {"x": x, "wq": wq, "k": k, "v": v}, None, (d, dv))
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=x.dtype, device=x.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=x.device)
    build.launch("fused_qproj_attention_fwd", x.data_ptr(), wq.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, hq, hkv, sq, skv, e, d, dv, int(causal),
                 causal_anchor(q_offset, sq, skv),
                 float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x))
    return out, lse


class _FusedQprojAttention(torch.autograd.Function):
    """Forward #10 saving (x, wq, k, v, o, lse); backward as _fqa_bwd."""

    @staticmethod
    def forward(ctx, x, wq, k, v, causal, scale, q_offset, rope_theta,
                plain):
        x, wq = x.contiguous(), wq.contiguous()
        k, v = k.contiguous(), v.contiguous()
        fwd = fused_qproj_attention_fwd_plain if plain \
            else fused_qproj_attention_fwd
        o, lse = fwd(x, wq, k, v, causal=causal, scale=scale,
                     q_offset=q_offset, rope_theta=rope_theta)
        ctx.save_for_backward(x, wq, k, v, o, lse)
        ctx.args = (causal, scale, q_offset, rope_theta, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        x, wq, k, v, o, lse = ctx.saved_tensors
        causal, scale, q_offset, rope_theta, plain = ctx.args
        # recompute the rotated Q (a product and a rotation) and reuse
        # the training attention's backward on it
        q, pos = _project(x, wq, x.shape[1], k.shape[2], q_offset,
                          rope_theta)
        dq, dk, dv = attention_backward(
            q.contiguous(), k, v, o, lse, do, causal=causal,
            scale=scale if scale is not None else wq.shape[-1] ** -0.5,
            q_offset=q_offset, plain=plain)
        if rope_theta is not None:
            # the rotation is orthogonal: d(unrotated q) = R(-pos) dq
            dq = ref.rope(dq, -pos, rope_theta)
        dx = torch.einsum("bhsd,ehd->bse", dq.float(),
                          wq.float()).to(x.dtype)
        dwq = torch.einsum("bse,bhsd->ehd", x.float(),
                           dq.float()).to(wq.dtype)
        return dx, dwq, dk, dv, None, None, None, None, None


def fused_qproj_attention(x, wq, k, v, *, causal: bool = True,
                          scale: Optional[float] = None, q_offset=None,
                          rope_theta: Optional[float] = None,
                          plain: bool = False):
    """Differentiable Fig. 5b schedule over the whole sequence: Q = x @
    Wq (+ RoPE at ``q_offset + r``) built inside the forward kernel
    ``fused_qproj_attention_fwd``, never stored.  x (B, Sq, E), wq (E,
    Hq, D), k, v (B, Hkv, Skv, D[v]).  ``plain`` runs the plain versions
    on the card too."""
    return _FusedQprojAttention.apply(x, wq, k, v, causal, scale, q_offset,
                                      rope_theta, plain)
