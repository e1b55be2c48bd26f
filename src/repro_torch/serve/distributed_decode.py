"""Distributed decode of the port (``repro/serve/distributed_decode.py``):
the sequence-sharded partial-softmax combine and the head-parallel
decode step, over the active mesh's ranks.

Sequence-sharded: each rank attends over its slice of the cache's time
columns and the ranks combine their partial online-softmax states,

    per rank:  o_i = sum_j exp(s_ij - m_i) v_j ;  (m_i, l_i)
    combine :  m* = max_i m_i ;  o = sum_i exp(m_i - m*) o_i
                                     / sum_i exp(m_i - m*) l_i

which is exact: softmax is associative under this combine.  The only
cross-rank traffic is the (m, l, o) triple.

Head-parallel: each rank runs its contiguous slice of heads at full
depth, applies its slice of the output projection, and the ranks'
(B, S, d_model) partials are summed with one ``psum``: the lowered form
of the DSE's head->core allocation (``launch/mesh_lowering.py``).

The per-rank partial is plain PyTorch in fp32, as the JAX package's
``_local_partial`` is plain jnp (no Pallas kernel).  Both functions
take this rank's blocks, the blocks of the sharded serving state
(``serve/layout.py``): the body of JAX's
``shard_map``, with no slicing of whole tensors.  The refusals of a
head count or a ``max_len`` the axis does not divide are
:func:`check_head_parallel` and :func:`check_seq_sharded`, which the
serving layout applies to the global shapes before any block exists.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import pmax, psum

NEG_INF = -1e30


def _local_partial(q, k, v, first_col: int, lengths, scale: float):
    """Partial attention over this rank's kv columns.
    q: (B, H, S1, D); k, v: (B, Hkv, Sl, D); returns (o, m, l) in fp32."""
    b, hq, sq, d = q.shape
    hkv, sl = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group * sq, d).float()
    s = torch.einsum("bngd,bnkd->bngk", qg, k.float()) * scale
    cols = first_col + torch.arange(sl, device=q.device)
    valid = cols[None, :] < lengths[:, None]                # (B, Sl)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.max(dim=-1).values                                # (B,Hkv,G*S1)
    p = torch.exp(s - m[..., None])
    # a fully masked shard: its contribution exactly zero
    dead = m <= NEG_INF / 2
    p = torch.where(dead[..., None], torch.zeros_like(p), p)
    m = torch.where(dead, torch.full_like(m, NEG_INF), m)
    l = p.sum(dim=-1)
    o = torch.einsum("bngk,bnkd->bngd", p, v.float())
    return o, m, l


def check_seq_sharded(seq: int, n_shards: int, axis: str = "model") -> None:
    """Raise unless a cache of ``seq`` time columns splits over the
    ``n_shards`` ranks of ``axis``."""
    if seq % n_shards:
        raise ValueError(f"sequence-sharded decode needs the cache's "
                         f"max_len {seq} divisible by the {axis!r} axis "
                         f"({n_shards} ranks)")


def check_head_parallel(hq: int, hkv: int, n_shards: int,
                        axis: str = "model") -> None:
    """Raise unless ``hq`` query and ``hkv`` KV heads split over the
    ``n_shards`` ranks of ``axis`` (a head group must not straddle
    ranks)."""
    if hq % n_shards or hkv % n_shards:
        raise ValueError(
            f"head-parallel decode needs heads divisible by the "
            f"{axis!r} axis: Hq={hq}, Hkv={hkv}, shards={n_shards}")


def distributed_decode_attention(q, k, v, lengths, *,
                                 scale: Optional[float] = None,
                                 axis: str = "model", plan=None):
    """Exact attention over a cache whose time dim is sharded over
    ``axis``, the ranks' partial softmax states combined.  This rank's
    blocks: q (B, Hq, S1, D), every head; k, v (B, Hkv, S/n, D), its
    time columns (rank i holds columns i·S/n onward); lengths (B,)
    per-row valid lengths (a rank wholly past a row's prefix
    contributes a zeroed partial).  B is this rank's rows.  Needs an
    active mesh.  Returns (B, Hq, S1, Dv), the same on every rank of
    ``axis``.

    ``plan`` (a ``lower.runtime.PlanDispatch``): annotated, not
    consulted; the per-rank partial is the streamed score pipeline, so
    the plan's ledger records that (a downgrade where its path is not
    ``fused_attention``, and a note)."""
    if plan is not None:
        if plan.path != "fused_attention":
            plan.plan.record_downgrade(
                "distributed decode always streams the score pipeline "
                "(partial-softmax shard combine)", plan.path,
                "fused_attention")
        plan.plan.note(
            f"distributed decode over axis {axis!r}: cross-shard "
            "traffic is the (m, l, o) partial-softmax triple only")
    mesh = shrules.active_mesh()
    bl, hq, sq, d = q.shape
    sl, dv = k.shape[2], v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    o, m, l = _local_partial(q, k, v, mesh.axis_index(axis) * sl, lengths,
                             scale)
    m_star = pmax(m, mesh, axis)
    w = torch.exp(m - m_star)
    o = psum(o * w[..., None], mesh, axis)
    l = psum(l * w, mesh, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).reshape(bl, hq, sq, dv).to(q.dtype)


def head_parallel_decode_attention(q, k, v, lengths, wo, *,
                                   scale: Optional[float] = None,
                                   axis: str = "model", plan=None):
    """Head-partitioned decode step: each rank along ``axis`` owns a
    contiguous slice of heads, runs their full-depth attention, applies
    its slice of ``wo``, and the ranks' (B, S, d_model) partials are
    summed with one ``psum``.  Returns that sum (the caller adds the
    residual).  This rank's blocks: q (B, Hq/n, S1, D); k, v (B, Hkv/n,
    S, D), full depth; wo (Hq/n, Dv, d_model); lengths (B,).  The head
    counts' divisibility is :func:`check_head_parallel`'s."""
    mesh = shrules.active_mesh()
    bl, hq_local, sq, d = q.shape
    dv = v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    if plan is not None:
        if plan.path != "fused_attention":
            plan.plan.record_downgrade(
                "head-parallel decode streams each shard's score "
                "pipeline (per-head partition, one output psum)",
                plan.path, "fused_attention")
        plan.plan.note(
            f"head-parallel decode over axis {axis!r}: cross-shard "
            "traffic is one (B, S, d_model) output partial per shard")
    o, m, l = _local_partial(q, k, v, 0, lengths, scale)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (o / l[..., None]).reshape(bl, hq_local, sq, dv)
    out = torch.einsum("bhse,hed->bsd", o, wo.float())
    return psum(out, mesh, axis).to(q.dtype)
