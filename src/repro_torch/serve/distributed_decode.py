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
``_local_partial`` is plain jnp (no Pallas kernel).  The bodies run
through ``sharding.collectives.shard_map`` on the global tensors every
rank holds.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import pmax, psum, shard_map

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


def _batch_spec(mesh):
    """The batch dim's spec entry: the mesh's (pod, data) axes."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if len(batch_axes) > 1:
        return batch_axes
    return batch_axes[0] if batch_axes else None


def distributed_decode_attention(q, k, v, lengths, *,
                                 scale: Optional[float] = None,
                                 axis: str = "model", plan=None):
    """Exact attention over a cache whose time dim is sharded over
    ``axis``, the ranks' partial softmax states combined.  q: (B, Hq,
    S1, D); k, v: (B, Hkv, S, D); lengths: (B,) per-row valid lengths (a
    rank wholly past a row's prefix contributes a zeroed partial).
    Needs an active mesh; S must divide over ``axis``.

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
    b, hq, sq, d = q.shape
    hkv, seq = k.shape[1], k.shape[2]
    dv = v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    n_shards = shrules.mesh_sizes(mesh)[axis]
    if seq % n_shards:
        raise ValueError(f"sequence-sharded decode needs the cache's "
                         f"max_len {seq} divisible by the {axis!r} axis "
                         f"({n_shards} ranks)")
    sl = seq // n_shards

    def per_shard(q, k, v, lengths):
        bl = q.shape[0]
        idx = mesh.axis_index(axis)
        o, m, l = _local_partial(q, k, v, idx * sl, lengths, scale)
        m_star = pmax(m, mesh, axis)
        w = torch.exp(m - m_star)
        o = psum(o * w[..., None], mesh, axis)
        l = psum(l * w, mesh, axis)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = (o / l[..., None]).reshape(bl, hq, sq, dv)
        return out.to(q.dtype)

    bspec = _batch_spec(mesh)
    fn = shard_map(per_shard, mesh,
                   in_specs=((bspec, None, None, None),
                             (bspec, None, axis, None),
                             (bspec, None, axis, None),
                             (bspec,)),
                   out_specs=(bspec, None, None, None))
    return fn(q, k, v, lengths)


def head_parallel_decode_attention(q, k, v, lengths, wo, *,
                                   scale: Optional[float] = None,
                                   axis: str = "model", plan=None):
    """Head-partitioned decode step: each rank along ``axis`` owns a
    contiguous slice of heads, runs their full-depth attention, applies
    its slice of ``wo`` (Hq, Dv, d_model), and the ranks' (B, S,
    d_model) partials are summed with one ``psum``.  Returns that sum
    (the caller adds the residual).  q: (B, Hq, S1, D); k, v: (B, Hkv,
    S, D), full depth.  Raises ValueError where the axis does not
    divide both Hq and Hkv (a head group must not straddle ranks)."""
    mesh = shrules.active_mesh()
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    n_shards = shrules.mesh_sizes(mesh)[axis]
    if hq % n_shards or hkv % n_shards:
        raise ValueError(
            f"head-parallel decode needs heads divisible by the "
            f"{axis!r} axis: Hq={hq}, Hkv={hkv}, shards={n_shards}")
    if plan is not None:
        if plan.path != "fused_attention":
            plan.plan.record_downgrade(
                "head-parallel decode streams each shard's score "
                "pipeline (per-head partition, one output psum)",
                plan.path, "fused_attention")
        plan.plan.note(
            f"head-parallel decode over axis {axis!r}: cross-shard "
            "traffic is one (B, S, d_model) output partial per shard")

    def per_shard(q, k, v, lengths, wo):
        bl, hq_local = q.shape[0], q.shape[1]
        o, m, l = _local_partial(q, k, v, 0, lengths, scale)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        o = (o / l[..., None]).reshape(bl, hq_local, sq, dv)
        out = torch.einsum("bhse,hed->bsd", o, wo.float())
        return psum(out, mesh, axis)

    bspec = _batch_spec(mesh)
    fn = shard_map(per_shard, mesh,
                   in_specs=((bspec, axis, None, None),
                             (bspec, axis, None, None),
                             (bspec, axis, None, None),
                             (bspec,),
                             (axis, None, None)),
                   out_specs=(bspec, None, None))
    return fn(q, k, v, lengths, wo).to(q.dtype)
