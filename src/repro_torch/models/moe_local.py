"""Fully local MoE dispatch of the port (``repro/models/moe_local.py``):
every rank routes and places its own tokens (a per-rank capacity), and
the only cross-rank traffic is the expert all-to-all pair over the
mesh's "model" axis.

The per-rank capacity C_l = max(8, ceil(T_l·k/E·cf / 8)·8) is the
production semantics (vLLM/DeepSeek-EP): drop decisions are per rank.
With a capacity factor high enough to drop nothing the result equals
the global ``moe.moe_forward``.  The two aux losses are per-rank values
averaged over every mesh axis (``pmean``).

Where the tokens do not divide over the mesh's ranks, or the experts
over its "model" axis, the JAX package falls back to its global
``moe_forward``, logged here once.  (Its fallback passes the config on
with ``moe_local_dispatch`` still set, so ``moe_forward`` calls back
into this function until Python's recursion limit; this port takes the
global path with the flag off, the result that fallback means.)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, mlp_forward
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import (all_to_all, gather_spec, pmean,
                                              shard_map, to_stream)

#: whether the fallback to the global path was logged
_FALLBACK_LOGGED: list = []


def moe_forward_local(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      aux: bool = True, specs=None, seq: bool = False):
    """``moe.moe_forward`` under a mesh with a "model" axis: x (B, S, d)
    -> (y, aux dict).  ``specs`` (the sharded serving state): where the
    experts are this rank's blocks over "model" they enter as they are,
    and where the router is, its columns are gathered (every rank
    routes its own tokens over every expert: the in-spec JAX's
    ``shard_map`` gives it, d x E fp32).  ``seq``: as ``moe_forward``'s
    (``x`` whole, ``y`` this rank's sequence block)."""
    mesh = moe_mod.ep_mesh()
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_dev = mesh.size
    tokens = b * s
    sizes = shrules.mesh_sizes(mesh)
    if tokens % n_dev or e % sizes["model"]:
        if not _FALLBACK_LOGGED:
            _FALLBACK_LOGGED.append(True)
            print(f"moe_local: {tokens} tokens over {n_dev} ranks, {e} "
                  f"experts over {sizes['model']}: the global moe_forward "
                  "(the JAX package's fallback)", flush=True)
        return moe_mod.moe_forward(
            params, dataclasses.replace(cfg, moe_local_dispatch=False), x,
            aux=aux, specs=specs, seq=seq)

    all_axes = tuple(mesh.axis_names)
    t_local = tokens // n_dev
    cap = moe_mod.capacity(cfg, t_local)
    dt = x.dtype

    def body(t_loc, router, wg, wu, wd):
        # t_loc: (T_l, d), this rank's tokens; w*: its experts
        logits, probs, topw, topi = moe_mod.route(router, t_loc, k)
        buf, slot, order = moe_mod._dispatch(t_loc[None], topi[None],
                                             cap, e)
        # token-routing all-to-all: slots travel to their expert's rank
        buf = all_to_all(buf[0], mesh, "model", split_axis=0,
                         concat_axis=1)
        g = torch.einsum("ecd,edf->ecf", buf, wg)
        u = torch.einsum("ecd,edf->ecf", buf, wu)
        h = F.silu(g.float()).to(dt) * u
        out = torch.einsum("ecf,efd->ecd", h, wd)
        out = all_to_all(out, mesh, "model", split_axis=1, concat_axis=0)
        y = moe_mod._combine(out[None], slot, order, topw[None], t_local,
                             k)[0]
        onehot = F.one_hot(topi, e).float()                  # (T_l,k,E)
        lb = torch.mean(onehot.mean(dim=(0, 1)) * e
                        * probs.mean(dim=0) * e)
        zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return y, pmean(lb, mesh, all_axes), pmean(zl, mesh, all_axes)

    router = params["router"].float()
    if shrules.splits(specs and specs["router"], -1, mesh):
        router = gather_spec(router, (None, "model"), mesh)
    # local experts: sliced out of global weights, or already blocks
    wspec = None if shrules.splits(specs and specs["w_gate"], 0, mesh) \
        else ("model", None, None)
    fn = shard_map(body, mesh,
                   in_specs=((all_axes, None),       # tokens over every axis
                             (None, None),           # router replicated
                             wspec, wspec, wspec),
                   out_specs=((all_axes, None), (), ()))
    y, lb, zl = fn(x.reshape(tokens, d), router, params["w_gate"].to(dt),
                   params["w_up"].to(dt), params["w_down"].to(dt))
    y = to_stream(y.reshape(b, s, d), mesh, partial=False, seq=seq)
    if "shared" in params:
        y = y + mlp_forward(params["shared"], x, cfg.mlp,
                            specs and specs["shared"], seq=seq)
    if not aux:
        return y, {}
    return y, {"moe_lb_loss": lb, "moe_z_loss": zl}
