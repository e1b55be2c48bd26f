"""``fused_decode_block``: the whole M=1 attention sub-block in one
launch (Q projection + RoPE, masked softmax over the prefix, P.V, the
output projection summed over heads, and the residual), as a CUDA
kernel for Hopper (``csrc/fused_decode_block.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/fused_decode_block.py``
``fused_decode_block``.  The heads' contributions are summed in head
order in fp32, deterministically, as the TPU kernel sums them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import check_cuda_args


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
    # per-(row, head) fp32 partials and the per-row ticket counters of
    # the deterministic head reduction
    partial = torch.empty((b, hq, e), dtype=torch.float32, device=x.device)
    counter = torch.zeros((b,), dtype=torch.int32, device=x.device)
    build.launch("fused_decode_block", x.data_ptr(), wq.data_ptr(),
                 k.data_ptr(), v.data_ptr(), wo.data_ptr(),
                 residual.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 partial.data_ptr(), counter.data_ptr(), b, hq, hkv, skv,
                 e, d, dv, float(scale), float(rope_theta or 0.0),
                 int(rope_theta is not None), build.dtype_code(x))
    return out
