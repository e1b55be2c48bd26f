"""Attention blocks of the port (``repro/models/attention.py``): GQA
and MLA (deepseek-v3's Multi-head Latent Attention), dispatching to the
kernel the serving plan picked through ``kernels.ops``.

KV-cached calls (decode, chunked prefill) append the new K/V to the
cache and pass a ``lengths`` mask; the masked kernels anchor causal
rows at the end of the valid prefix, which is this module's
``q_offset = cache_len = lengths - s``.  With a per-row (B,)
``cache_len`` (the continuous-batching engine's state) each row appends
at its own position and ``lengths = cache_len + 1`` alone carries each
row's causal frontier.

With ``block_tables`` the cache leaves are page pools (num_pages, Hkv,
page, Dh) and the append is page-indirect: row b's new token lands in
pool page ``block_tables[b, cache_len[b] // page]`` at offset
``cache_len[b] % page``; attention reads the pool back through the same
table.

Unlike the JAX package, the cache append is an in-place write into the
caller's cache tensors (an indexed assignment for per-row and paged
appends, a slice assignment for the uniform one), and the returned
cache is the same dict: serving never keeps the pre-append cache.

MLA caches the *latent*, one shared "KV head" of (B, S, r_kv + rope)
rows (576 wide at deepseek-v3's widths) instead of per-head K and V,
and its cached calls run the absorbed form: ``q_nope @ W_UK`` moves the
queries into latent space, so K is the latent row and V its first r_kv
columns, a view of the same storage, and attention runs at D = r_kv +
rope, Dv = r_kv over the one latent head, scaled by (nope + rope)^-0.5
as the per-head form is.  The cache-free call (training, a plain
forward) forms per-head K and V and runs at D = nope + rope, Dv = v.
Paged latent caches are refused, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, rms_norm, rope
from repro_torch.serve.distributed_decode import (
    distributed_decode_attention, head_parallel_decode_attention)
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import (all_to_all, gather_spec,
                                              to_stream)


def _cache_write(cache_len, b: int, s: int, device):
    """(starts, lengths, q_offset, per_row) for the two conventions: a
    uniform int ``cache_len`` keeps the scalar ``q_offset``; a per-row
    (B,) tensor drops it (single-token steps only)."""
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
        if s != 1:
            raise NotImplementedError(
                "per-row cache_len supports single-token decode steps; "
                "run multi-token (chunked) prefill per request with a "
                "scalar cache_len, then insert() the result")
        starts = cache_len.to(torch.int32)
        return starts, starts + s, None, True
    start = int(cache_len)
    return (start, torch.full((b,), start + s, dtype=torch.int32,
                              device=device), start, False)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, E) by w (E, H, D) as (B, H, S, D): one 2-D product, as
    the JAX package's einsum is one dot_general without batch
    dimensions (``aten.mm``, which ``remat="dots"`` keeps)."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(
        b, s, w.shape[1], w.shape[2]).transpose(1, 2)


def _model_axis(mesh) -> tuple:
    """(rank count, this rank's index) of ``mesh``'s "model" axis; (1,
    0) without one."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1, 0
    return mesh.axis_size("model"), mesh.axis_index("model")


def _gather_heads(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's heads (dim 1) of ``x``, in rank order."""
    return gather_spec(x, (None, "model"), mesh)


def _write_columns(pairs, starts, s: int, per_row: bool, first: int,
                   dim: int = 2) -> None:
    """Write each new ``(buffer, rows)`` pair of ``pairs`` into this
    rank's time columns ``first``..``first + buffer.shape[dim]`` of the
    cache, in place (time along ``dim`` of both: 2 for K/V of every
    head, 1 for MLA's latent): the rows whose write position it owns
    (per-row decode), or the part of ``starts``..``starts + s`` it owns
    (a chunk)."""
    for buf, new in pairs:
        sl = buf.shape[dim]
        if per_row:
            rows = torch.arange(buf.shape[0], device=buf.device)
            loc = starts.long() - first
            own = (loc >= 0) & (loc < sl)
            at = loc.clamp(0, sl - 1)
            idx = (rows, slice(None), at) if dim == 2 else (rows, at)
            cur = buf[idx]
            buf[idx] = torch.where(own.view(-1, *[1] * (cur.ndim - 1)),
                                   new.select(dim, 0).to(buf.dtype), cur)
            continue
        lo, hi = max(starts, first), min(starts + s, first + sl)
        if lo < hi:
            buf.narrow(dim, lo - first, hi - lo).copy_(
                new.narrow(dim, lo - starts, hi - lo))


def _query_kv_heads(t: torch.Tensor, first: int, count: int,
                    group: int) -> torch.Tensor:
    """The K or V heads (dim 1, every KV head: a cache, or the ``wk``/
    ``wv`` projection of a cache-free call) that the query heads
    ``first``..``first + count`` read, where the query heads are this
    rank's block and the KV heads whole (their count does not divide
    the ranks): the KV heads of the rank's query groups, which the
    kernel pairs with the query heads at its GQA ratio, where the block
    holds whole groups or lies inside one; else, where the block parts
    a group, one KV head per query head."""
    lo, hi = first // group, (first + count - 1) // group + 1
    if hi - lo == 1 or (first % group == 0 and count % group == 0):
        return t.narrow(1, lo, hi - lo).contiguous()
    idx = torch.arange(first, first + count, device=t.device) // group
    return t.index_select(1, idx)


def gqa_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[dict] = None,
                cache_len=None, block_tables: Optional[torch.Tensor] = None,
                plan=None, residual: Optional[torch.Tensor] = None,
                impl: str = "auto", specs: Optional[dict] = None,
                seq: bool = False):
    """x: (B, S, E).  With ``cache``: append K/V at ``cache_len`` (in
    place) and attend over the valid prefix.  ``plan``: a
    ``lower.runtime.PlanDispatch``; ``plan.fuse_q`` hands x and Wq to
    the kernel (which builds and rotates Q itself), ``plan.fuse_wo``
    runs the whole M=1 sub-block in the decode megakernel.
    ``residual``: the block's skip input; the returned output already
    includes it.  ``block_tables``: (B, max_pages) page ids; the cache
    leaves are then page pools and the append page-indirect.  Dead rows
    (zeroed table row, length 0) write into the allocator's null page
    0, which no live row reads.  Single-token per-row decode only:
    prefill runs dense and is paged when the engine inserts it.
    ``impl``: the ``kernels.ops`` impl of every attention call (``auto``
    follows the plan, else the device); a cache-free call is the
    differentiable training attention.

    ``specs`` (the sharded serving state, ``serve/layout.py``, or the
    tensor-parallel training layout, ``train/step.py``): the leaves'
    specs, which say which projections are this rank's heads
    (``wq``/``wk``/``wv`` (E, H/n, D), ``wo`` (H/n, D, E)); each is
    whole where its head count does not divide the "model" axis, as
    JAX's rules fall back.  Every path attends over the rank's query
    heads and one ``psum`` over "model" sums the ranks' output
    partials (its backward the ``psum`` of the ranks' shares,
    ``sharding/collectives.py``); with the KV heads whole, the rank
    reads its query groups' KV heads (:func:`_query_kv_heads`).  The
    cache-free call (training) runs #7-#9 at the rank's head counts,
    qk-norm per head.  Under ``distributed_decode`` the cache holds this
    rank's time columns of every KV head: the new K/V (and a decode
    step's q) are gathered over the heads where they are blocks, the
    rank owning a column writes it, a decode step runs the
    partial-softmax combine, and a prefill chunk reads its heads' whole
    depth for the call: one ``all_to_all`` turns the layer's columns
    into the rank's KV heads, or, with the KV heads whole, the columns
    are gathered.
    ``seq`` (``seq_stream``): ``x`` is the whole sequence, gathered from
    the ranks' blocks, and ``residual`` this rank's block; the output
    partials are reduce-scattered to the block instead of summed
    (``collectives.to_stream``), or the whole output sliced to it.
    Returns (out, cache)."""
    dt = x.dtype
    b, s, _ = x.shape
    decode = cache is not None
    paged = block_tables is not None
    if paged and not decode:
        raise NotImplementedError(
            "paged KV is a decode-time storage format; prefill runs "
            "dense and is paged at insert() time")
    # the multi-device decode paths, inert without an active mesh:
    # ``dist`` the sequence-sharded partial-softmax combine, ``hp`` the
    # DSE head->core allocation lowered onto the mesh's model axis (each
    # rank its heads at full depth, one psum of the output partials)
    mesh = shrules.active_mesh()
    dist = decode and cfg.distributed_decode and s == 1 \
        and mesh is not None
    hp = decode and cfg.head_parallel_decode and s == 1 and not dist \
        and mesh is not None
    if paged and (hp or dist):
        raise NotImplementedError(
            "paged KV does not compose with the distributed "
            "decode paths yet")
    n_model, r_model = _model_axis(mesh)
    if (hp or dist) and n_model > 1 and specs is None:
        raise ValueError(
            "under a mesh with a model axis the decode paths run on the "
            "sharded serving state, each rank its blocks "
            "(serve.layout.serving_layout)")
    # which projections are this rank's heads (the layout's specs)
    q_split = shrules.splits(specs and specs["wq"], 1, mesh)
    kv_split = shrules.splits(specs and specs["wk"], 1, mesh)
    wo_split = shrules.splits(specs and specs["wo"], 0, mesh)
    hq_l = params["wq"].shape[1]
    # the rank's query heads over whole KV heads: each reads its own
    expand = q_split and not kv_split
    # a cache of this rank's time columns of every KV head
    seq_split = decode and specs is not None and n_model > 1 \
        and cfg.distributed_decode
    fuse_q = decode and not dist and not hp and plan is not None \
        and plan.fuse_q and not cfg.qk_norm

    def own(t):
        return _query_kv_heads(t, r_model * hq_l, hq_l,
                               cfg.n_heads // cfg.kv_heads)

    theta = float(cfg.rope_theta) if cfg.rope_theta else None

    wk, wv = params["wk"], params["wv"]
    if expand and not decode:
        # cache-free: project only the KV heads the rank's query heads
        # read
        wk, wv = own(wk), own(wv)
    k_new = _heads(x, wk.to(dt))
    v_new = _heads(x, wv.to(dt))
    if cfg.qk_norm:
        k_new = rms_norm(k_new, params["k_norm"])
    k_new = rope(k_new, positions, cfg.rope_theta)
    if not fuse_q:
        q = _heads(x, params["wq"].to(dt))
        if cfg.qk_norm:
            q = rms_norm(q, params["q_norm"])
        q = rope(q, positions, cfg.rope_theta)

    if not decode:
        o = ops.attention(q, k_new, v_new, causal=cfg.causal, plan=plan,
                          impl=impl)
        new_cache = None
    else:
        starts, lengths, q_off, per_row = _cache_write(cache_len, b, s,
                                                       x.device)
        kc, vc = cache["k"], cache["v"]
        if paged:
            if not per_row:
                raise NotImplementedError(
                    "paged KV requires per-row (B,) cache_len")
            # page-indirect append: row r's token lands at offset
            # starts % page of its current page
            page = kc.shape[2]
            idx = starts.long()
            page_ids = block_tables[torch.arange(b, device=x.device),
                                    idx // page].long()
            kc[page_ids, :, idx % page] = k_new[:, :, 0].to(kc.dtype)
            vc[page_ids, :, idx % page] = v_new[:, :, 0].to(vc.dtype)
        elif seq_split:
            if not per_row and starts + s > kc.shape[2] * n_model:
                raise ValueError(f"cache append at {starts}+{s} overruns "
                                 f"max_len {kc.shape[2] * n_model}")
            k_all, v_all = ((_gather_heads(t, mesh) for t in (k_new, v_new))
                            if kv_split else (k_new, v_new))
            _write_columns(((kc, k_all), (vc, v_all)), starts, s, per_row,
                           r_model * kc.shape[2])
        elif per_row:
            # continuous batching: row r appends at its own position
            rows = torch.arange(b, device=x.device)
            idx = starts.long()
            kc[rows, :, idx] = k_new[:, :, 0].to(kc.dtype)
            vc[rows, :, idx] = v_new[:, :, 0].to(vc.dtype)
        else:
            if starts + s > kc.shape[2]:
                raise ValueError(f"cache append at {starts}+{s} overruns "
                                 f"max_len {kc.shape[2]}")
            kc[:, :, starts:starts + s] = k_new.to(kc.dtype)
            vc[:, :, starts:starts + s] = v_new.to(vc.dtype)
        new_cache = cache
        k_buf, v_buf = kc.to(dt), vc.to(dt)
        if seq_split and not dist:
            # a chunk attends over its heads' whole prefix, for this
            # call: the layer's time columns turned into this rank's KV
            # heads, or every KV head's gathered
            k_buf, v_buf = ((all_to_all(t, mesh, "model", split_axis=1,
                                        concat_axis=2) if kv_split else
                             gather_spec(t, (None, None, "model"), mesh))
                            for t in (k_buf, v_buf))
        if expand and not (hp or dist):
            k_buf, v_buf = own(k_buf), own(v_buf)
        if hp:
            out = head_parallel_decode_attention(
                q, k_buf, v_buf, lengths, params["wo"].to(dt), plan=plan)
            if residual is not None:
                out = residual + out
            return out, new_cache
        if dist:
            if q_split:
                q = _gather_heads(q, mesh)
            o = distributed_decode_attention(q, k_buf, v_buf, lengths,
                                             plan=plan)
            if wo_split:            # back to this rank's heads
                hl = params["wo"].shape[0]
                o = o[:, r_model * hl:(r_model + 1) * hl]
        elif fuse_q:
            wq = params["wq"].to(dt)
            if plan.fuse_wo and s == 1 and residual is not None \
                    and not wo_split:
                out = ops.decode_block(x, wq, k_buf, v_buf,
                                       params["wo"].to(dt), residual,
                                       lengths, block_tables=block_tables,
                                       rope_theta=theta, plan=plan,
                                       impl=impl)
                return out, new_cache
            o = ops.qproj_attention(x, wq, k_buf, v_buf, causal=cfg.causal,
                                    q_offset=q_off, lengths=lengths,
                                    block_tables=block_tables,
                                    rope_theta=theta, plan=plan, impl=impl)
        else:
            o = ops.attention(q, k_buf, v_buf, causal=cfg.causal,
                              q_offset=q_off, lengths=lengths,
                              block_tables=block_tables, plan=plan,
                              impl=impl)
    wo = params["wo"].to(dt)
    out = o.transpose(1, 2).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    # the ranks' partials over their heads (GSPMD's heads-sharded
    # einsum), summed or reduce-scattered to the stream's block
    out = to_stream(out, mesh, partial=wo_split, seq=seq)
    if residual is not None:
        out = residual + out
    return out, new_cache


def init_gqa(cfg: ModelConfig, draw, ones) -> dict:
    """A GQA block's leaves: ``draw(*shape)`` for each projection,
    ``ones(d)`` for each qk-norm, in the JAX tree's keys."""
    h, hk, dh, e = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    p = {"wq": draw(e, h, dh), "wk": draw(e, hk, dh),
         "wv": draw(e, hk, dh), "wo": draw(h, dh, e)}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = ones(dh), ones(dh)
    return p


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, lead: tuple = ()) -> dict:
    """Zeroed (*lead, B, Hkv, max_len, Dh) K and V buffers."""
    shape = (*lead, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, draw, ones) -> dict:
    """An MLA block's leaves (the JAX package's ``init_mla``):
    ``draw(*shape)`` for each projection, ``ones(r)`` for its two norms,
    ``q_a_norm`` (r_q,) and ``kv_a_norm`` (r_kv,)."""
    d, h = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    return {"wq_a": draw(d, r_q), "q_a_norm": ones(r_q),
            "wq_b": draw(r_q, h, nope + rope_d),
            "wkv_a": draw(d, r_kv + rope_d), "kv_a_norm": ones(r_kv),
            "wk_b": draw(r_kv, h, nope), "wv_b": draw(r_kv, h, dv),
            "wo": draw(h, dv, d)}


def _mla_q(params, cfg: ModelConfig, x, positions, dt):
    """(q_nope, q_rope), each (B, H, S, .): the low-rank query, normed,
    expanded per head, its rope part rotated."""
    cq = rms_norm(x @ params["wq_a"].to(dt), params["q_a_norm"])
    q = _heads(cq, params["wq_b"].to(dt))
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(params, cfg: ModelConfig, x, positions, dt):
    """(c, k_rope): the normed latent (B, S, r_kv) and the shared rope
    key (B, S, rope), rotated."""
    ckv = x @ params["wkv_a"].to(dt)
    r = cfg.kv_lora_rank
    c = rms_norm(ckv[..., :r], params["kv_a_norm"])
    k_rope = rope(ckv[..., r:][:, None], positions, cfg.rope_theta)[:, 0]
    return c, k_rope


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale of both MLA forms: the per-head query width
    (nope + rope)^-0.5, never the latent width's."""
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def mla_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[dict] = None,
                cache_len=None, block_tables: Optional[torch.Tensor] = None,
                plan=None, residual: Optional[torch.Tensor] = None,
                impl: str = "auto", specs: Optional[dict] = None,
                seq: bool = False):
    """x: (B, S, E).  Without ``cache``: per-head K/V, causal attention
    at D = nope + rope, Dv = v (the differentiable training attention).
    With ``cache``: append the latent rows at ``cache_len`` (in place,
    along axis 1 of the (B, max_len, r_kv + rope) leaf) and attend in
    the absorbed form over the valid prefix, one latent KV head: K the
    latent, V its first r_kv columns (a view of K's storage).  ``plan``:
    a ``lower.runtime.PlanDispatch`` whose impl the attention call takes
    (no Q or Wo fusion here, as in the JAX package).  ``residual`` is
    added to the output.

    ``specs`` (the sharded serving state, ``serve/layout.py``, or the
    tensor-parallel training layout, ``train/step.py``): the
    leaves' specs, which say whether ``wq_b``/``wk_b``/``wv_b``/``wo``
    are this rank's heads, and, under ``"latent"``, the latent cache's
    spec, which says whether it holds this rank's time columns (whole
    where ``max_len`` does not divide the "model" axis).  Every path
    runs at the rank's query heads and one ``psum`` over "model" sums
    the output partials; the latent rows, computed whole on every
    rank, are written by the rank owning their columns.  A decode step
    (S = 1) over split columns gathers the absorbed queries of every
    head and runs the partial-softmax combine over the rank's own
    columns (Hkv 1, V the first r_kv columns of K), so no rank gathers
    the latent; a prefill chunk gathers the layer's columns for the
    call.  MLA's one latent head has no head-parallel form, so
    ``head_parallel_decode`` takes the same path.  The cache-free
    (training) path computes the latent ``c`` and the shared rope key
    whole on every rank, from ``wq_a``/``wkv_a`` and their norms whole
    on "model": each rank's cotangent of them is its heads' share,
    which the layout's ``enter`` sums into the whole leaves'
    gradients.  ``seq``: as :func:`gqa_forward`'s (the latent rows and
    their cache columns come from the whole sequence).  Returns (out,
    cache)."""
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV is not supported for MLA latent caches")
    dt = x.dtype
    b, s, _ = x.shape
    mesh = shrules.active_mesh()
    n_model, r_model = _model_axis(mesh)
    # which leaves are this rank's blocks (the layout's specs)
    q_split = shrules.splits(specs and specs["wq_b"], 1, mesh)
    wo_split = shrules.splits(specs and specs["wo"], 0, mesh)
    seq_split = cache is not None and specs is not None \
        and shrules.splits(specs["latent"], 1, mesh)
    q_nope, q_rope = _mla_q(params, cfg, x, positions, dt)
    c, k_rope = _mla_latent(params, cfg, x, positions, dt)
    scale = mla_scale(cfg)
    h_l = q_nope.shape[1]

    if cache is None:
        k_nope = _heads(c, params["wk_b"].to(dt))
        v = _heads(c, params["wv_b"].to(dt))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, None].expand(
            b, h_l, s, cfg.qk_rope_head_dim)], dim=-1)
        o = ops.attention(q, k, v, causal=cfg.causal, scale=scale,
                          plan=plan, impl=impl)
        new_cache = None
    else:
        # absorbed: q_nope @ W_UK, per head, into latent space
        q_lat = q_nope @ params["wk_b"].to(dt).permute(1, 2, 0)
        q_full = torch.cat([q_lat, q_rope], dim=-1)
        latent_new = torch.cat([c, k_rope], dim=-1)
        starts, lengths, q_off, per_row = _cache_write(cache_len, b, s,
                                                       x.device)
        buf = cache["latent"]
        if seq_split:
            if not per_row and starts + s > buf.shape[1] * n_model:
                raise ValueError(f"cache append at {starts}+{s} overruns "
                                 f"max_len {buf.shape[1] * n_model}")
            _write_columns(((buf, latent_new),), starts, s, per_row,
                           r_model * buf.shape[1], dim=1)
        elif per_row:
            buf[torch.arange(b, device=x.device), starts.long()] = \
                latent_new[:, 0].to(buf.dtype)
        else:
            if starts + s > buf.shape[1]:
                raise ValueError(f"cache append at {starts}+{s} overruns "
                                 f"max_len {buf.shape[1]}")
            buf[:, starts:starts + s] = latent_new.to(buf.dtype)
        new_cache = cache
        k_lat = buf.to(dt)[:, None]                  # (B, 1, S, r + rope)
        r = cfg.kv_lora_rank
        if seq_split and s == 1:
            # the combine over the ranks' own columns: every head's
            # queries, the same (B, H, 1, r) out on every rank
            if q_split:
                q_full = _gather_heads(q_full, mesh)
            o_lat = distributed_decode_attention(
                q_full, k_lat, k_lat[..., :r], lengths, scale=scale,
                plan=plan)
            if q_split:                 # back to this rank's heads
                o_lat = o_lat[:, r_model * h_l:(r_model + 1) * h_l]
        else:
            if seq_split:
                # a chunk reads the layer's whole prefix, for this call
                k_lat = gather_spec(k_lat, (None, None, "model"), mesh)
            o_lat = ops.attention(q_full, k_lat, k_lat[..., :r],
                                  causal=cfg.causal, q_offset=q_off,
                                  scale=scale, lengths=lengths, plan=plan,
                                  impl=impl)  # (B, H, S, r)
        o = o_lat @ params["wv_b"].to(dt).transpose(0, 1)
    wo = params["wo"].to(dt)
    out = o.transpose(1, 2).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    # the ranks' partials over their heads
    out = to_stream(out, mesh, partial=wo_split, seq=seq)
    if residual is not None:
        out = residual + out
    return out, new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, lead: tuple = ()) -> dict:
    """The zeroed latent cache (*lead, B, max_len, r_kv + rope)."""
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return {"latent": torch.zeros((*lead, batch, max_len, width),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, draw, ones) -> dict:
    """The config's attention leaves: :func:`init_mla` or
    :func:`init_gqa`."""
    if cfg.attention == "mla":
        return init_mla(cfg, draw, ones)
    return init_gqa(cfg, draw, ones)


def attention_forward(params: dict, cfg: ModelConfig, x, positions, *,
                      specs: Optional[dict] = None, **kw):
    """The config's attention block: :func:`mla_forward` or
    :func:`gqa_forward` (``specs``: the sharded serving state's)."""
    if cfg.attention == "mla":
        return mla_forward(params, cfg, x, positions, specs=specs, **kw)
    return gqa_forward(params, cfg, x, positions, specs=specs, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               lead: tuple = ()) -> dict:
    """The config's attention cache: the latent or the K/V buffers."""
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device, lead)
    return init_gqa_cache(cfg, batch, max_len, dtype, device, lead)
