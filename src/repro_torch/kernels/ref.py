"""Plain-PyTorch oracles of the kernels (a port of
``repro/kernels/ref.py``): the layer-by-layer realisations that
materialise the whole score matrix, the schedule the fused kernels
avoid.  They are the ``reference`` impl the plan picks below the
crossovers, and ground truth for the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*n_rep, S, D) for the GQA broadcast."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=1)


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        lengths: Optional[torch.Tensor] = None,
                        q_offset: Optional[int] = None):
    """Unfused attention: QK^T materialised, row softmax, then @V.
    ``q_offset`` aligns the causal mask when q is a suffix of the KV
    sequence (default Skv - Sq); ``lengths`` (B,) masks columns past
    each row's valid prefix.  Rows with no valid column emit zeros."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    group = hq // k.shape[1]
    k = repeat_kv(k, group).float()
    v = repeat_kv(v, group).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    mask = None
    cols = torch.arange(skv, device=q.device)
    if causal:
        off = (skv - sq) if q_offset is None else q_offset
        rows = off + torch.arange(sq, device=q.device)[:, None]
        mask = (cols[None, :] <= rows)[None, None]
    if lengths is not None:
        lmask = (cols[None, :] < lengths[:, None])[:, None, None, :]
        mask = lmask if mask is None else (mask & lmask)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        # a row with no valid column has m == NEG_INF, so exp(s - m) is
        # 1, not 0: zero it so such rows emit zeros
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30), v)
    return o.to(q.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding oracle written against the RoFormer definition
    (``theta ** (-i / half)``), sharing no code with the model's rope:
    half-split pairs rotated by ``positions * theta^(-i/half)`` in fp32.
    x: (..., S, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    inv_freq = torch.tensor(theta, dtype=torch.float32) ** (
        -torch.arange(half, dtype=torch.float32) / half)
    ang = positions.float()[..., None] * inv_freq.to(x.device)
    while ang.ndim < x.ndim:
        ang = ang.unsqueeze(-3)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope_positions(sq: int, skv: int,
                   lengths: Optional[torch.Tensor] = None,
                   q_offset: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Rotary positions of the Sq query rows under the kernels' causal
    anchor: with ``lengths``, row r of batch b sits at
    ``lengths[b] - sq + r``; without, at ``q_offset + r`` (default
    ``skv - sq``)."""
    if lengths is not None:
        r = torch.arange(sq, dtype=torch.int32, device=lengths.device)
        return lengths.to(torch.int32)[:, None] - sq + r[None, :]
    off = (skv - sq) if q_offset is None else q_offset
    return off + torch.arange(sq, dtype=torch.int32, device=device)


def qproj_attention_reference(x, wq, k, v, *,
                              rope_theta: Optional[float] = None, **kw):
    """Unfused oracle of the Q-projection schedule: Q = x @ Wq
    materialised, RoPE between projection and scores, then attention."""
    q = torch.einsum("bse,ehd->bhsd", x, wq.to(x.dtype))
    if rope_theta is not None:
        pos = rope_positions(x.shape[1], k.shape[2],
                             lengths=kw.get("lengths"),
                             q_offset=kw.get("q_offset"), device=x.device)
        q = rope(q, pos, rope_theta)
    return attention_reference(q, k, v, **kw)


def decode_block_reference(x, wq, k, v, wo, residual, lengths, *,
                           rope_theta: Optional[float] = None,
                           scale: Optional[float] = None):
    """Unfused oracle of the whole M=1 decode attention sub-block: Q
    projection (+ RoPE at ``lengths[b] - 1``), masked attention over the
    valid prefix, output projection, residual add."""
    if x.shape[1] != 1:
        raise ValueError("decode_block_reference is the M=1 schedule")
    q = torch.einsum("bse,ehd->bhsd", x, wq.to(x.dtype))
    if rope_theta is not None:
        q = rope(q, rope_positions(1, k.shape[2], lengths=lengths),
                 rope_theta)
    o = attention_reference(q, k, v, causal=False, scale=scale,
                            lengths=lengths)
    y = torch.einsum("bhse,hed->bsd", o.float(), wo.float())
    return (residual.float() + y).to(x.dtype)


def gather_pages(pool: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Densify a paged KV pool: (num_pages, Hkv, page, D) gathered
    through (B, max_pages) integer page ids into the dense
    (B, Hkv, max_pages*page, D) layout every dense oracle and kernel
    takes.  Row b's j-th logical block is pool page
    ``block_tables[b, j]``; entries past a row's valid length may name
    any in-range page (canonically the allocator's null page 0): the
    caller's ``lengths`` mask makes their content irrelevant."""
    b, max_pages = block_tables.shape
    _, hkv, page, d = pool.shape
    g = pool[block_tables.long()]        # (B, max_pages, Hkv, page, D)
    return g.movedim(2, 1).reshape(b, hkv, max_pages * page, d)


def paged_attention_reference(q, k_pool, v_pool, lengths, block_tables,
                              **kw):
    """Oracle of ``fused_attention_paged``: gather the pages dense, then
    the unfused lengths-masked attention."""
    return attention_reference(
        q, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), lengths=lengths, **kw)


def paged_qproj_attention_reference(x, wq, k_pool, v_pool, lengths,
                                    block_tables, **kw):
    """Oracle of ``fused_qproj_attention_paged``."""
    return qproj_attention_reference(
        x, wq, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), lengths=lengths, **kw)


def paged_decode_block_reference(x, wq, k_pool, v_pool, wo, residual,
                                 lengths, block_tables, **kw):
    """Oracle of ``fused_decode_block_paged``."""
    return decode_block_reference(
        x, wq, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), wo, residual, lengths, **kw)


# ---------------------------------------------------------------------------
# the training attention: forward with lse, and its backward
# (repro/kernels/fused_attention.py _fwd :139-186 and _bwd :514-610)
# ---------------------------------------------------------------------------

def _train_scores(q, k, causal: bool, scale: float, q_offset):
    """Scaled fp32 scores (B, Hq, Sq, Skv) with the GQA heads expanded,
    and the (Sq, Skv) mask of visible columns (None: all).  Row r sees
    column c iff c <= q_offset + r (default q_offset = Skv - Sq)."""
    sq, skv = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     repeat_kv(k, group).float()) * scale
    if not causal:
        return s, None
    off = (skv - sq) if q_offset is None else int(q_offset)
    rows = off + torch.arange(sq, device=q.device)[:, None]
    return s, torch.arange(skv, device=q.device)[None, :] <= rows


def attention_fwd_plain(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None, q_offset=None):
    """The forward of the training attention, whole score matrix at
    once: returns (o, lse) with o (B, Hq, Sq, Dv) in q's dtype and lse
    (B, Hq, Sq) fp32, ``lse = m + log(l)``.  p is rounded to V's dtype
    before P.V; a row with no visible column emits 0 and lse = m =
    NEG_INF (``l`` counted as 1), as ``_emit_softmax_out``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    s, mask = _train_scores(q, k, causal, scale, q_offset)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                     repeat_kv(v, group).float()) / l_safe[..., None]
    return o.to(q.dtype), m + torch.log(l_safe)


def attention_delta(o, do) -> torch.Tensor:
    """delta = sum(o * dO) over the head width, fp32 (B, Hq, Sq): the
    backward's row term, computed outside its kernels as ``_bwd``
    computes it."""
    return (o.float() * do.float()).sum(-1)


def _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, q_offset):
    """p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) *
    scale with dp = dO . V^T in fp32, both (B, Hq, Sq, Skv)."""
    group = q.shape[1] // k.shape[1]
    s, mask = _train_scores(q, k, causal, scale, q_offset)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      repeat_kv(v, group).float())
    return p, p * (dp - delta.float()[..., None]) * scale


def _group_sum(x, hkv: int):
    """(B, Hq, ...) -> (B, Hkv, ...): the GQA group's sum."""
    b, hq = x.shape[:2]
    return x.reshape(b, hkv, hq // hkv, *x.shape[2:]).sum(2)


def attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                           scale: Optional[float] = None, q_offset=None):
    """dq = (ds rounded to K's dtype) . K, fp32 sums, in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, q_offset)
    group = q.shape[1] // k.shape[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      repeat_kv(k, group).float())
    return dq.to(q.dtype)


def attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                            scale: Optional[float] = None, q_offset=None):
    """(dk, dv): dv = (p rounded to dO's dtype)^T . dO and dk = (ds
    rounded to Q's dtype)^T . Q, summed over the GQA group, fp32 sums,
    in K's and V's dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, q_offset)
    hkv = k.shape[1]
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return _group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype)


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None, q_offset=None):
    """(dq, dk, dv) of the training attention from the residuals (q, k,
    v, o, lse) and the cotangent dO, by the formulas of the TPU
    backward kernels (not by autograd through the forward)."""
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    dq = attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def ssd_reference(x, dt, a, b, c, d=None, *, h0=None,
                  return_final_state: bool = False):
    """Mamba-2 SSD sequential-scan oracle (``repro/kernels/ref.py``
    ``ssd_reference``), all in fp32:

        h_t = exp(a * dt_t) * h_{t-1} + dt_t * x_t (outer) b_t
        y_t = h_t . c_t + d * x_t

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, S), the G
    groups broadcast over the H heads; d: (H,) or None; h0: (B, H, P, S)
    or None (zeros).  Returns y in x's dtype (and the final state)."""
    bsz, length, h, p = x.shape
    rep = h // b.shape[2]
    bb = b.repeat_interleave(rep, dim=2).float()
    cc = c.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(a.float()[None, None, :] * dtf)         # (B, L, H)
    state = torch.zeros((bsz, h, p, b.shape[3]), dtype=torch.float32,
                        device=x.device) if h0 is None else h0.float()
    ys = []
    for t in range(length):
        upd = (xf[:, t] * dtf[:, t][..., None])[..., None] \
            * bb[:, t][:, :, None, :]
        state = state * decay[:, t][:, :, None, None] + upd
        ys.append(torch.einsum("bhps,bhs->bhp", state, cc[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(xf.shape)
    if d is not None:
        y = y + d.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    return (y, state) if return_final_state else y
