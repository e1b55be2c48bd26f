"""The decoder stack of the port (``repro/models/transformer.py``):
dense GQA attention layers, and the Mamba-2 layers of a pure-mamba stack
(``cfg.block_kind(i) == "mamba"``: pre-norm, the mamba block, the
residual add, and no FFN sublayer).

Parameters keep the JAX package's tree: ``prefix_layers`` (a list) and
``layers`` (one dict per position in the layer period, every leaf with
a leading ``n_periods`` axis).  Caches mirror it: ``{"prefix": [...],
"scan": [...]}``.  The JAX ``lax.scan`` over periods is a Python loop
here; each period's parameters and caches are views into the stacked
tensors, so cache appends land in the stacked cache in place.  Paged
caches (page pools, the body's with the leading ``n_periods`` axis)
take the same walk, with one block table shared by every layer.

A cache-free forward with autograd on is a training forward: each layer
is rematerialised per ``cfg.remat`` (``"full"``: its activations are
recomputed in the backward, ``torch.utils.checkpoint`` around the layer,
as ``jax.checkpoint`` around the JAX package's scanned period), and its
attention runs the differentiable ``kernels.ops`` path.  Gradients reach
whatever leaves the caller marks: ``train.step`` hands in one view per
layer of each stacked leaf, so every layer's gradient is written once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.common import ModelConfig, mlp_forward, rms_norm


def check_ported(cfg: ModelConfig) -> None:
    """Admit the stacks the port runs: dense GQA decoders and pure
    Mamba-2 stacks.  MoE, MLA, the attention/mamba hybrid and modality
    frontends are refused."""
    dense = cfg.attn_every == 1 and cfg.attention == "gqa"
    if cfg.moe or cfg.frontend != "none" or not (dense
                                                 or cfg.attn_every == 0):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA decoders and pure "
            "Mamba-2 stacks only")


def _index(tree, j: int):
    """Period ``j`` of a stacked parameter or cache tree (views; a leaf
    given as a list of per-period tensors yields its j-th)."""
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def _layer_forward(lp: dict, cfg: ModelConfig, kind: str, x, positions,
                   layer_cache, cache_len, plan, block_tables=None,
                   impl="auto"):
    h = rms_norm(x, lp["pre_norm"])
    if kind == "mamba":
        h, _ = mb.mamba_forward(
            lp["mamba"], cfg, h,
            cache=None if layer_cache is None else layer_cache["mamba"],
            impl=impl)
        x = x + h
    else:
        # the attention block owns its residual add: the decode
        # megakernel folds it into the launch, every other path adds it
        # in gqa_forward
        x, _ = attn.gqa_forward(
            lp["attn"], cfg, h, positions,
            cache=None if layer_cache is None else layer_cache["attn"],
            cache_len=cache_len, block_tables=block_tables, plan=plan,
            residual=x, impl=impl)
    if "mlp" not in lp:
        return x                    # pure mamba2: no FFN sublayer
    h = rms_norm(x, lp["ffn_norm"])
    return x + mlp_forward(lp["mlp"], h, cfg.mlp)


def _remat(cfg: ModelConfig) -> bool:
    """Whether a training forward recomputes each layer in the
    backward (``cfg.remat``)."""
    if cfg.remat == "full":
        return True
    if cfg.remat == "none":
        return False
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"{cfg.name}: remat='dots' (JAX's dots_with_no_batch_dims_"
            "saveable policy) is not ported; use 'full' or 'none'")
    raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[dict] = None, cache_len=None,
            positions: Optional[torch.Tensor] = None, plan=None,
            block_tables: Optional[torch.Tensor] = None,
            return_aux: bool = False, impl: str = "auto"):
    """tokens: (B, S) integer ids.  ``cache``/``cache_len``: KV-cached
    mode; ``cache_len`` is an int (the whole batch at one context) or a
    (B,) tensor of per-row write positions.  ``plan``: a
    ``lower.runtime.PlanDispatch`` routing every attention block.
    ``block_tables``: (B, max_pages) int32 page table of paged caches,
    shared by every layer.  ``impl``: the ``kernels.ops`` impl of every
    attention and SSD call (``torch`` forces the plain versions on the
    card).
    Returns logits (B, S, vocab), plus the cache (updated in place) when
    one is given, plus, with ``return_aux``, the auxiliary losses (zeros:
    the dense stack has no MoE)."""
    check_ported(cfg)
    dt = cfg.torch_dtype()
    x = params["embed"].to(dt)[tokens]
    b, s, _ = x.shape
    if positions is None:
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
            positions = cache_len.to(torch.int32)[:, None] + ar[None, :]
        else:
            start = 0 if cache_len is None else int(cache_len)
            positions = (start + ar)[None, :].expand(b, s)

    remat = cache is None and torch.is_grad_enabled() and _remat(cfg)

    def layer(i, lp, lc, x):
        kind = cfg.block_kind(i)
        if remat:
            return checkpoint(_layer_forward, lp, cfg, kind, x, positions,
                              None, None, plan, None, impl,
                              use_reentrant=False)
        return _layer_forward(lp, cfg, kind, x, positions, lc, cache_len,
                              plan, block_tables, impl)

    for i, lp in enumerate(params["prefix_layers"]):
        x = layer(i, lp, None if cache is None else cache["prefix"][i], x)
    for j in range(cfg.n_periods):
        for pos in range(cfg.layer_period):
            lc = None if cache is None else _index(cache["scan"][pos], j)
            x = layer(cfg.first_dense_layers + pos,
                      _index(params["layers"][pos], j), lc, x)

    x = rms_norm(x, params["final_norm"])
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(dt)
    else:
        logits = x @ params["embed"].to(dt).T
    out = [logits] if cache is None else [logits, cache]
    if return_aux:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        out.append({"moe_lb_loss": zero, "moe_z_loss": zero})
    return out[0] if len(out) == 1 else tuple(out)


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed caches in the parameter tree's layout: a list for the
    prefix layers, ``n_periods``-stacked tensors for the body.  An
    attention layer holds ``{"attn": {"k", "v"}}`` (``max_len`` rows), a
    mamba layer ``{"mamba": {"conv", "ssm"}}`` (the SSM state fp32)."""
    check_ported(cfg)

    def layer(i, lead=()):
        if cfg.block_kind(i) == "attn":
            return {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                                device, lead)}
        return {"mamba": mb.init_mamba_cache(cfg, batch, dtype, device,
                                             lead)}
    return {"prefix": [layer(i) for i in range(cfg.first_dense_layers)],
            "scan": [layer(cfg.first_dense_layers + pos, (cfg.n_periods,))
                     for pos in range(cfg.layer_period)]}
