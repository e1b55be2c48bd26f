"""Parameters of the port: random init from an explicit generator, and
the bridge from the JAX package's parameter tree (and its AdamW
state).

Both give the JAX tree's structure and layout: ``embed`` (V, E),
``frontend_proj`` (F, E) for a config with a stub modality frontend
(``cfg.frontend != "none"``, F = ``cfg.frontend_dim``),
``prefix_layers`` (a list of the ``first_dense_layers`` dense-FFN
layers before the body, without a leading axis), ``layers`` (one dict
per period position, leaves stacked over ``n_periods``), ``final_norm``,
``lm_head`` (E, V); per attention layer ``pre_norm``, ``attn`` {``wq``
(E, Hq, D), ``wk``/``wv`` (E, Hkv, D), ``wo`` (Hq, D, E)[, ``q_norm``,
``k_norm``]} for GQA or, for MLA (``cfg.attention == "mla"``), {``wq_a``
(E, r_q), ``q_a_norm`` (r_q,), ``wq_b`` (r_q, Hq, nope + rope),
``wkv_a`` (E, r_kv + rope), ``kv_a_norm`` (r_kv,), ``wk_b`` (r_kv, Hq,
nope), ``wv_b`` (r_kv, Hq, v), ``wo`` (Hq, v, E)}, ``ffn_norm`` and
either ``mlp`` {``w_up``, ``w_down``[, ``w_gate``]} or, where ``cfg.ffn_kind(i) == "moe"``, ``moe``
{``router`` (E, X) in fp32 whatever the parameter dtype,
``w_gate``/``w_up`` (X, E, Fx), ``w_down`` (X, Fx, E)[, ``shared``, an
MLP of width Fx·n_shared]} (X experts of width Fx = ``d_expert``); per
mamba layer ``pre_norm`` and ``mamba`` {``in_proj`` (E, 2 d_inner +
2 G S + H), ``conv_w`` (W, d_inner + 2 G S), ``conv_b``, ``a_log``,
``d_skip`` and ``dt_bias`` (H,) in fp32 whatever the parameter dtype,
``norm`` (d_inner,), ``out_proj`` (d_inner, E)}, then the FFN sublayer
(``ffn_norm`` and ``mlp`` or ``moe``, by ``cfg.ffn_kind(i)``) in a
hybrid stack, and none in a pure Mamba-2 one (``attn_every == 0`` and
``d_ff == 0``, the JAX package's ``_init_layer`` rule).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import map as tree_map


def params_from_numpy(tree, cfg: ModelConfig, device="cuda", dtype=None,
                      *, fsdp=None):
    """The JAX parameter tree (leaves already ``np.asarray``'d by the
    caller) as tensors on ``device``, same structure.  ``dtype`` casts
    the floating leaves but the MoE router, which stays fp32 as the
    JAX package keeps it; default: keep each leaf's dtype (numpy's
    bfloat16 extension type becomes torch.bfloat16 exactly).  ``fsdp``
    (a ``sharding.fsdp.FSDP``): each leaf becomes this rank's block
    under its spec, cut on the host, so no whole leaf reaches
    ``device``."""
    from repro_torch.sharding.rules import block_index, shard_shape

    dev = resolve_device(device)

    def block(arr, spec):
        """This rank's block of ``arr`` under ``spec`` (a numpy view)."""
        mesh = fsdp.mesh
        local = shard_shape(arr.shape, spec, mesh)
        cut = []
        for i, entry in enumerate(spec):
            idx, _ = block_index(entry, mesh, mesh.coords)
            cut.append(slice(idx * local[i], (idx + 1) * local[i]))
        return arr[tuple(cut)]

    tf.check_ported(cfg)

    def conv(x, key=None, spec=None):
        if isinstance(x, dict):
            return {k: conv(v, k, None if spec is None else spec[k])
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, None, None if spec is None else spec[i])
                    for i, v in enumerate(x)]
        arr = np.asarray(x)
        if spec is not None:
            arr = block(arr, spec)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))       # a writable copy
        if dtype is not None and t.is_floating_point() and key != "router":
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree, spec=None if fsdp is None else fsdp.specs)


def _stacked(shape, lead: int, generator, device, dtype,
             scale=None, cut=None) -> torch.Tensor:
    """``lead`` stacked draws of the JAX package's init: a normal
    truncated to [-2, 2] times ``scale`` (default 1/sqrt(fan_in),
    fan_in = shape[0]), drawn in fp32 one slice at a time.  ``cut``
    (FSDP): each slice is cut to this rank's block of the stacked
    tensor as soon as it is drawn, and only the blocks are kept."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0] if len(shape) > 1
                                    else shape[-1], 1))
    full = (lead, *shape)
    if cut is not None:
        full = cut(torch.empty(full, device="meta")).shape
    out = torch.empty(full, dtype=dtype, device=device)
    tmp = torch.empty(shape, dtype=torch.float32, device=device)
    for j in range(lead):
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        out[j] = tmp * scale if cut is None else cut(tmp[None])[0] * scale
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", *, cuts=None) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn
    from ``generator`` (which must live on that device).  Not the JAX
    package's numbers for the same seed: tests share weights through
    :func:`params_from_numpy` instead.  Raises ValueError where no layer
    follows the dense prefix (``n_layers <= first_dense_layers``), a
    depth the JAX package cannot build either.  ``cuts`` (FSDP):
    ``cuts(i)`` is the function that takes the i-th tensor made (in
    :func:`draw_order`'s order), or any run of its leading axis, to
    this rank's block of it; the tree then holds the blocks, from the
    same draws."""
    return _init_params(cfg, generator, resolve_device(device), cuts, [])


def draw_order(cfg: ModelConfig) -> tuple:
    """(a tree of :func:`init_params`' structure holding the index of
    the tensor each leaf is made from, in the order they are made; the
    shapes of those tensors): a leaf is its tensor, or that tensor's
    one slice along a leading axis of 1."""
    made = []
    p = _init_params(cfg, None, torch.device("meta"), None, made)
    index = {id(t): i for i, t in enumerate(made)}
    order = tree_map(
        lambda x: index[id(x if x._base is None else x._base)], p)
    return order, [tuple(t.shape) for t in made]


def _init_params(cfg: ModelConfig, generator, dev, cuts, made) -> dict:
    """:func:`init_params`, appending each tensor made to ``made``."""
    tf.check_ported(cfg)
    if cfg.n_periods < 1:
        raise ValueError(
            f"{cfg.name}: no layer follows the dense prefix (n_layers "
            f"{cfg.n_layers}, first_dense_layers {cfg.first_dense_layers}); "
            "cut the prefix with the depth")
    dt = cfg.torch_dtype("param")
    e = cfg.d_model

    def cut():
        return None if cuts is None else cuts(len(made))

    def w(*shape, scale=None, lead=1, dtype=None):
        made.append(_stacked(shape, lead, generator, dev, dtype or dt,
                             scale, cut()))
        return made[-1]

    def ones(*shape, dtype=dt):
        c = cut()
        if c is not None:
            shape = c(torch.empty(shape, device="meta")).shape
        made.append(torch.ones(shape, dtype=dtype, device=dev))
        return made[-1]

    def layer(i, n):
        """Layer ``i``'s leaves with a leading axis of ``n``."""
        draw = functools.partial(w, lead=n)
        if cfg.block_kind(i) == "mamba":
            d_in, hs, _, g, s = mb.dims(cfg)
            conv_dim = d_in + 2 * g * s
            f32 = torch.float32
            out = {"pre_norm": ones(n, e), "mamba": {
                "in_proj": draw(e, 2 * d_in + 2 * g * s + hs),
                "conv_w": draw(cfg.conv_width, conv_dim, scale=0.5),
                "conv_b": draw(conv_dim, scale=0.01),
                "a_log": draw(hs, scale=1.0, dtype=f32),
                "d_skip": ones(n, hs, dtype=f32),
                "dt_bias": draw(hs, scale=0.5, dtype=f32),
                "norm": ones(n, d_in),
                "out_proj": draw(d_in, e)}}
            if cfg.attn_every == 0 and cfg.d_ff == 0:
                return out          # a pure Mamba-2 stack: no FFN
        else:
            out = {"pre_norm": ones(n, e), "attn": attn_mod.init_attention(
                cfg, draw, lambda *shape: ones(n, *shape))}
        out["ffn_norm"] = ones(n, e)
        if cfg.ffn_kind(i) == "moe":
            out["moe"] = moe_mod.init_moe(cfg, draw)
            return out
        mlp = {"w_up": draw(e, cfg.d_ff), "w_down": draw(cfg.d_ff, e)}
        if cfg.mlp == "silu_glu":
            mlp["w_gate"] = draw(e, cfg.d_ff)
        out["mlp"] = mlp
        return out

    prefix = [tree_map(lambda t: t[0], layer(i, 1))
              for i in range(cfg.first_dense_layers)]
    body = [layer(cfg.first_dense_layers + pos, cfg.n_periods)
            for pos in range(cfg.layer_period)]
    p = {"embed": w(cfg.vocab_size, e, scale=0.02)[0],
         "prefix_layers": prefix, "layers": body, "final_norm": ones(e)}
    if cfg.frontend != "none":
        p["frontend_proj"] = w(cfg.frontend_dim or e, e)[0]
    if not cfg.tie_embeddings:
        p["lm_head"] = w(e, cfg.vocab_size, scale=0.02)[0]
    return p


def _mlp_axes(cfg: ModelConfig) -> dict:
    p = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.mlp == "silu_glu":
        p["w_gate"] = ("embed", "mlp")
    return p


def _layer_axes(cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s logical axes, in its leaves' keys (the JAX package's
    ``_init_layer``)."""
    out = {"pre_norm": ("embed_act",)}
    if cfg.block_kind(i) == "mamba":
        out["mamba"] = {
            "in_proj": ("embed", "inner"), "conv_w": ("conv", "inner"),
            "conv_b": ("inner",), "a_log": ("ssm_heads",),
            "d_skip": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "norm": ("inner",), "out_proj": ("inner", "embed")}
        if cfg.attn_every == 0 and cfg.d_ff == 0:
            return out
    elif cfg.attention == "mla":
        out["attn"] = {
            "wq_a": ("embed", "latent"), "q_a_norm": ("latent",),
            "wq_b": ("latent", "heads", "head_dim"),
            "wkv_a": ("embed", "latent"), "kv_a_norm": ("latent",),
            "wk_b": ("latent", "heads", "head_dim"),
            "wv_b": ("latent", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    else:
        out["attn"] = {"wq": ("embed", "heads", "head_dim"),
                       "wk": ("embed", "kv_heads", "head_dim"),
                       "wv": ("embed", "kv_heads", "head_dim"),
                       "wo": ("heads", "head_dim", "embed")}
        if cfg.qk_norm:
            out["attn"]["q_norm"] = ("head_dim",)
            out["attn"]["k_norm"] = ("head_dim",)
    out["ffn_norm"] = ("embed_act",)
    if cfg.ffn_kind(i) == "moe":
        moe = {"router": ("embed", "experts"),
               "w_gate": ("experts", "expert_embed", "expert_mlp"),
               "w_up": ("experts", "expert_embed", "expert_mlp"),
               "w_down": ("experts", "expert_mlp", "expert_embed")}
        if cfg.n_shared_experts:
            moe["shared"] = _mlp_axes(cfg)
        out["moe"] = moe
    else:
        out["mlp"] = _mlp_axes(cfg)
    return out


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`init_params`' tree, a
    tree of the same structure with a tuple of axis names per leaf: the
    axes tree the JAX package's ``init_params_and_axes`` returns (a
    stacked ``layers`` leaf gains a leading None)."""
    tf.check_ported(cfg)
    p = {"embed": ("vocab", "embed"),
         "prefix_layers": [_layer_axes(cfg, i)
                           for i in range(cfg.first_dense_layers)],
         "layers": [tree_map(lambda ax: (None,) + ax,
                             _layer_axes(cfg, cfg.first_dense_layers + pos),
                             is_leaf=lambda x: isinstance(x, tuple))
                    for pos in range(cfg.layer_period)],
         "final_norm": ("embed_act",)}
    if cfg.frontend != "none":
        p["frontend_proj"] = ("embed_act", "embed")
    if not cfg.tie_embeddings:
        p["lm_head"] = ("embed", "vocab")
    return p


def adamw_state_from_numpy(step, mu, nu, cfg: ModelConfig, device="cuda"):
    """The JAX package's ``AdamWState`` (its ``step``, ``mu`` and ``nu``
    already ``np.asarray``'d by the caller) as the port's, on
    ``device``: the moments through :func:`params_from_numpy`, each
    leaf in its own dtype, and the step as a () int32 tensor."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=params_from_numpy(mu, cfg, dev), nu=params_from_numpy(nu, cfg, dev))
