"""Chunked online-softmax attention in plain PyTorch: a port of
``repro/kernels/xla_fallback.py:28-111`` ``chunked_attention``, and the
shared body of the three kernels' plain versions.

The score matrix is never materialised whole: query blocks of
``block_q`` rows walk the KV sequence ``block_k`` columns at a time,
carrying the running (max, sum, accumulator) in fp32.  One cast point
of the CUDA and TPU kernels is kept: p is rounded to V's dtype before
P.V (a no-op in fp32, where this equals the JAX fallback).  On the
``meta`` device, which holds no data, one block spans the whole
sequence: the same ops at shapes alone, without a Python loop over
thousands of blocks.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      q_offset: Union[int, torch.Tensor, None] = None,
                      lengths: Optional[torch.Tensor] = None,
                      block_q: int = 512,
                      block_k: int = 1024) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D[v]), GQA when Hkv < Hq.
    ``q_offset`` is the global position of query row 0, an int or a
    (B,) tensor (the masked kernels' per-row anchor ``lengths - Sq``);
    default ``Skv - Sq``.  ``lengths`` (B,) masks columns past each
    row's valid prefix; a row with no valid column emits zeros."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    off = (skv - sq) if q_offset is None else q_offset
    off = torch.as_tensor(off, device=dev).reshape(-1)        # (1,) or (B,)
    if dev.type == "meta":
        block_q, block_k = sq, skv
    bq, bk = min(block_q, max(sq, 1)), min(block_k, max(skv, 1))
    out = torch.empty(b, hq, sq, dv, dtype=q.dtype, device=dev)
    for q0 in range(0, sq, bq):
        qq = q[:, :, q0:q0 + bq].float()
        nq = qq.shape[2]
        qg = qq.reshape(b, hkv, group, nq, d)
        rows = off[:, None] + q0 + torch.arange(nq, device=dev)[None, :]
        m = torch.full((b, hkv, group, nq), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, group, nq), device=dev)
        acc = torch.zeros((b, hkv, group, nq, dv), device=dev)
        for k0 in range(0, skv, bk):
            kk = k[:, :, k0:k0 + bk].float()
            vv = v[:, :, k0:k0 + bk]
            cols = k0 + torch.arange(kk.shape[2], device=dev)
            s = torch.einsum("bngqd,bnkd->bngqk", qg, kk) * scale
            mask = torch.ones(b, 1, 1, 1, cols.shape[0], dtype=torch.bool,
                              device=dev)
            if lengths is not None:
                mask = mask & (cols[None, :] < lengths[:, None])[
                    :, None, None, None, :]
            if causal:
                mask = mask & (cols[None, None, :] <= rows[:, :, None])[
                    :, None, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            # rows with no valid column yet have m_new == NEG_INF, so
            # exp(s - m_new) = 1: the where keeps them out of the sums
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bngqk,bnkd->bngqd", p.to(vv.dtype).float(),
                              vv.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o = (acc / l_safe[..., None]).reshape(b, hq, nq, dv)
        out[:, :, q0:q0 + nq] = o.to(q.dtype)
    return out
