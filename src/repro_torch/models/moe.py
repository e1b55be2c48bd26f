"""Mixture-of-Experts FFN of the port (``repro/models/moe.py`` on one
device): phi3.5-moe's 16 experts top-2, deepseek-v3's routed experts
with a shared one.

Dispatch is sort-based token choice with a static capacity, step for
step with the JAX package's global path (the one it takes with no mesh):

  1. the router in fp32 (``x.float() @ router``, the router leaf fp32
     whatever the parameter dtype), softmax, top-k in ``jax.lax.top_k``'s
     tie order (the lower expert id first), weights renormalised;
  2. per group (a batch row, or ``moe_group_size`` tokens when the
     batch divides into such groups) the token copies stably sorted by
     expert id, each copy's rank within its expert from a searchsorted;
  3. copies at rank >= C (:func:`capacity`) go to a sentinel slot E·C,
     cut off the (E·C + 1, d) buffer;
  4. the expert products on the (B, E, C, d) buffer, batched over
     experts;
  5. the combine: each copy read back at its slot (the sentinel row
     zero), the permutation inverted, the k copies of a token weighted
     and summed.

The dispatch places tokens without a duplicate index in any backward
but the discarded sentinel row's: x expanded to its k copies in token
order, permuted by the sort (a permutation: its backward scatter has
unique indices) and placed at the slots.  So a backward on CUDA is
bitwise repeatable, where a gather ``x[order // k]`` would accumulate
each token's k copies by atomics.

Aux losses: the switch-style load balance and the router z-loss, fp32.
Under an active mesh whose data axes span more than one rank (training
on a data mesh, each rank on its rows of the batch) the load balance's
token fractions and mean probabilities are means over the global batch
(a differentiable ``pmean``) before their product, as JAX's under
GSPMD; the z-loss is a per-token mean, which the ranks' mean gives.

Under an active mesh with a "model" axis (``sharding.set_rules_for_mesh``)
two flags of the JAX package take their mesh paths:
``moe_local_dispatch`` routes each rank's own tokens
(``models/moe_local.py``), and ``moe_shard_map_ep`` runs step 4 as
explicit expert parallelism (:func:`_expert_compute_shard_map`).  With
no mesh both are inert, as in the JAX package.

Under the sharded serving state (``serve/layout.py``)
the layer holds this rank's blocks: E/n experts, the router's E/n
columns and the shared MLP's column blocks.  The router's local logits
are gathered over "model" before the softmax, so routing is the global
path's (the stable descending sort, capacity per group); the expert
products run on this rank's experts, their outputs gathered over
"model" (or ``moe_shard_map_ep``'s all-to-alls route the slots to
them); the shared MLP's partials are summed (``mlp_forward``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, mlp_forward
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import (all_gather, all_to_all, pmean,
                                              shard_map, to_stream)


def init_moe(cfg: ModelConfig, draw: Callable) -> dict:
    """The MoE leaves of one layer (``repro/models/moe.py:32-51``):
    ``router`` (d, E) fp32, ``w_gate``/``w_up`` (E, d, ff), ``w_down``
    (E, ff, d) and, with ``n_shared_experts``, a ``shared`` MLP of width
    ff·n_shared.  ``draw(*shape, dtype=None)`` draws one leaf (the
    caller's init rule and leading axes; ``dtype`` None: the parameter
    dtype)."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.d_expert or cfg.d_ff
    p = {"router": draw(d, e, dtype=torch.float32),
         "w_gate": draw(e, d, ff), "w_up": draw(e, d, ff),
         "w_down": draw(e, ff, d)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {"w_up": draw(d, sff), "w_down": draw(sff, d)}
        if cfg.mlp == "silu_glu":
            p["shared"]["w_gate"] = draw(d, sff)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: ``int(s·k/E·cf)`` rounded up to a
    multiple of 8, at least 8 (Python integers, as JAX's
    ``_capacity``)."""
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis in
    ``jax.lax.top_k``'s order: descending, ties to the lower index
    (``torch.topk`` breaks ties otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, k: int,
          split: bool = False) -> tuple:
    """x (B, S, d) -> (router logits, probabilities, top-k weights
    renormalised, top-k expert ids), all but the ids fp32.  ``split``:
    ``router`` is this rank's block of expert columns over "model", and
    every rank's logits are gathered first."""
    logits = x.float() @ router.float()
    if split:
        logits = all_gather(logits, (None,) * (logits.ndim - 1)
                            + ("model",), ep_mesh())
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, topw, topi


def _dispatch(x, topi, cap: int, e: int):
    """x (B, S, d), topi (B, S, k) -> ((B, E, C, d) buffer, slot, order),
    slot and order (B, S·k)."""
    b, s, d = x.shape
    k = topi.shape[-1]
    flat = topi.reshape(b, s * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_ids = torch.gather(flat, 1, order)
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(s * k, device=x.device) - first
    slot = torch.where(rank < cap, sorted_ids * cap + rank,
                       torch.full_like(rank, e * cap))
    copies = x.unsqueeze(2).expand(b, s, k, d).reshape(b, s * k, d)
    placed = torch.gather(copies, 1, order[..., None].expand(-1, -1, d))
    buf = x.new_zeros((b, e * cap + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), placed)
    return buf[:, :-1].reshape(b, e, cap, d), slot, order


def _combine(out_buf, slot, order, topw, s: int, k: int):
    """The (B, E, C, d) expert outputs back to (B, S, d): each copy read
    at its slot, unsorted, and its token's k copies weighted and summed
    in fp32 (one rounding to the compute dtype, as the JAX einsum)."""
    b, e, cap, d = out_buf.shape
    dt = out_buf.dtype
    flat = torch.cat([out_buf.reshape(b, e * cap, d),
                      out_buf.new_zeros((b, 1, d))], dim=1)
    copies = torch.gather(flat, 1, slot[..., None].expand(-1, -1, d))
    inv = torch.argsort(order, dim=-1, stable=True)
    per_tok = torch.gather(copies, 1, inv[..., None].expand(-1, -1, d))
    per_tok = per_tok.reshape(b, s, k, d).float()
    w = topw.to(dt).float()[..., None]
    return (per_tok * w).sum(dim=2).to(dt)


def ep_mesh():
    """The active mesh if it has a "model" axis (where the mesh paths
    run), else None."""
    mesh = shrules.active_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        return mesh
    return None


def _expert_compute_shard_map(buf, params: dict, dt,
                              blocks: bool = False):
    """Explicit expert parallelism over the mesh's "model" axis: each
    rank sends its groups' slots for every other rank's experts there
    (an all-to-all on the expert dim), runs its resident experts on
    every rank's slots, and a second all-to-all routes the results
    back.  buf: (G, E, C, d) -> (G, E, C, d).  The expert weights are
    global (each rank's sliced out), or with ``blocks`` this rank's E/n
    experts already (the sharded serving state), which enter as they
    are."""
    mesh = ep_mesh()
    sizes = shrules.mesh_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bspec = batch_axes if len(batch_axes) != 1 else batch_axes[0]
    wg, wu, wd = (params["w_gate"].to(dt), params["w_up"].to(dt),
                  params["w_down"].to(dt))

    def body(buf, wg, wu, wd):
        # buf: (G_l, E, C, d); w*: (E/n_ep, ...), this rank's experts
        buf = all_to_all(buf, mesh, "model", split_axis=1, concat_axis=0)
        # -> (G_l·n_ep, E/n_ep, C, d): every model peer's slots for the
        #    experts this rank owns
        g = torch.einsum("gecd,edf->gecf", buf, wg)
        u = torch.einsum("gecd,edf->gecf", buf, wu)
        h = F.silu(g.float()).to(buf.dtype) * u
        out = torch.einsum("gecf,efd->gecd", h, wd)
        return all_to_all(out, mesh, "model", split_axis=0, concat_axis=1)

    batch_tuple = batch_axes if isinstance(bspec, tuple) else (bspec,)
    full = sizes["model"]
    for a in batch_tuple:
        full *= sizes[a]
    if buf.shape[0] % full == 0:
        gspec = (*batch_tuple, "model")   # groups over every axis
    else:
        gspec = bspec                     # fallback: model-replicated
    wspec = None if blocks else ("model", None, None)
    fn = shard_map(body, mesh,
                   in_specs=((gspec, None, None, None), wspec, wspec,
                             wspec),
                   out_specs=(gspec, None, None, None))
    return fn(buf, wg, wu, wd)


def _local_experts(buf, params: dict, dt):
    """Step 4 on this rank's E/n experts (the sharded serving state's
    blocks): their slots of ``buf`` (G, E, C, d) through their
    products, every rank's outputs gathered over "model"."""
    mesh = ep_mesh()
    el = params["w_gate"].shape[0]
    first = mesh.axis_index("model") * el
    mine = buf[:, first:first + el]
    gate = torch.einsum("becd,edf->becf", mine, params["w_gate"].to(dt))
    up = torch.einsum("becd,edf->becf", mine, params["w_up"].to(dt))
    h = F.silu(gate.float()).to(dt) * up
    out = torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))
    return all_gather(out, (None, "model"), mesh)


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                aux: bool = True, specs: Optional[dict] = None,
                seq: bool = False):
    """x: (B, S, d) -> (y (B, S, d), aux dict), the aux dict
    ``{"moe_lb_loss", "moe_z_loss"}`` (fp32 scalars), or empty without
    ``aux``.  ``specs`` (the sharded serving state): the leaves' specs,
    which say whether the router and the experts are this rank's blocks
    over "model".  ``seq`` (``seq_stream``): ``x`` is the whole
    sequence, gathered from the ranks' blocks, so the routing groups,
    the capacity and the aux losses are the whole sequence's; ``y`` is
    this rank's sequence block: the routed experts' output (whole on
    every rank) sliced to it, the shared expert's partials
    reduce-scattered."""
    if cfg.moe_local_dispatch and ep_mesh() is not None:
        from repro_torch.models.moe_local import moe_forward_local
        return moe_forward_local(params, cfg, x, aux=aux, specs=specs,
                                 seq=seq)
    mesh = ep_mesh()
    x_in = x
    # this rank's experts, and their router columns, over "model"
    experts_split = shrules.splits(specs and specs["w_gate"], 0, mesh)
    router_split = shrules.splits(specs and specs["router"], -1, mesh)
    dt = x.dtype
    b_in, s_in, d = x.shape
    g = cfg.moe_group_size
    grouped = bool(g) and (b_in * s_in) % g == 0 and g < s_in * b_in
    if grouped:
        x = x.reshape(b_in * s_in // g, g, d)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)

    logits, probs, topw, topi = route(params["router"], x, k,
                                      router_split)

    buf, slot, order = _dispatch(x, topi, cap, e)
    if cfg.moe_shard_map_ep and mesh is not None:
        out_buf = _expert_compute_shard_map(buf, params, dt,
                                            experts_split)
    elif experts_split:
        out_buf = _local_experts(buf, params, dt)
    else:
        # ``moe_expert_major_dispatch`` is a layout constraint in the
        # JAX package (``constrain`` of the buffer), without a numeric
        # effect: it takes this global path
        gate = torch.einsum("becd,edf->becf", buf,
                            params["w_gate"].to(dt))
        up = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
        h = F.silu(gate.float()).to(dt) * up
        out_buf = torch.einsum("becf,efd->becd", h,
                               params["w_down"].to(dt))
    y = _combine(out_buf, slot, order, topw, s, k)
    if grouped:
        y = y.reshape(b_in, s_in, d)
    y = to_stream(y, mesh, partial=False, seq=seq)
    if "shared" in params:
        y = y + mlp_forward(params["shared"], x_in, cfg.mlp,
                            specs and specs["shared"], seq=seq)
    if not aux:
        return y, {}
    onehot = F.one_hot(topi, e).float()                      # (B,S,k,E)
    frac_tokens = onehot.mean(dim=(0, 1, 2)) * e
    mean_probs = probs.mean(dim=(0, 1)) * e
    axes = shrules.data_axes()
    if axes:
        # means over the global batch, whose rows the data ranks share
        # equally, before their product (GSPMD's global mean)
        mesh = shrules.active_mesh()
        frac_tokens = pmean(frac_tokens, mesh, axes)
        mean_probs = pmean(mean_probs, mesh, axes)
    lb_loss = torch.mean(frac_tokens * mean_probs)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
