"""The decoder stack of the port (``repro/models/transformer.py``):
attention layers (GQA, or deepseek-v3's MLA) whose FFN is a dense MLP
or a Mixture-of-Experts (``cfg.ffn_kind(i) == "moe"``,
``models/moe.py``; a dense prefix of ``first_dense_layers`` before
them), and Mamba-2 layers (``cfg.block_kind(i) == "mamba"``: pre-norm,
the mamba block, the residual add).  A pure Mamba-2 stack's layers have
no FFN sublayer; the hybrid's (jamba: ``attn_every`` 8, attention at
``attn_offset``) have one, dense or MoE by ``cfg.ffn_kind(i)``, as its
attention layers do.

Parameters keep the JAX package's tree: ``prefix_layers`` (a list) and
``layers`` (one dict per position in the layer period, every leaf with
a leading ``n_periods`` axis).  Caches mirror it: ``{"prefix": [...],
"scan": [...]}``.  The JAX ``lax.scan`` over periods is a Python loop
here; each period's parameters and caches are views into the stacked
tensors, so cache appends land in the stacked cache in place.  Paged
caches (page pools, the body's with the leading ``n_periods`` axis)
take the same walk, with one block table shared by every layer.

A modality frontend's stub (hubert-xlarge's audio frames,
internvl2-2b's image patches) enters as ``embeds`` (B, S_f,
frontend_dim): ``embeds @ frontend_proj`` is placed before the token
embeddings, and positions and ``cache_len`` run over the whole
concatenated sequence.

A cache-free forward with autograd on is a training forward: each layer
is rematerialised per ``cfg.remat`` and its attention runs the
differentiable ``kernels.ops`` path.  ``"full"`` recomputes all of a
layer's activations in the backward (``torch.utils.checkpoint`` around
the layer, as ``jax.checkpoint`` around the JAX package's scanned
period).  ``"dots"`` is JAX's ``dots_with_no_batch_dims_saveable``: a
selective checkpoint that keeps the outputs of the products with no
batch dimension, the layer's 2-D ``aten.mm`` calls (the q/k/v/o
projections, the MLP's products and the MoE router, each ``x @ W``
folded over the leading dimensions), and recomputes the rest: norms,
RoPE, the MLP's activation, the attention and the MoE's dispatch,
expert products (``aten.bmm``, batched over experts) and combine.  A
checkpointed layer returns its MoE aux losses beside its output.  The attention kernels launch through
``ctypes``, outside the dispatcher, so no policy sees them: under
``"dots"`` the forward kernel runs again in the backward, as under
``"full"`` (and as JAX recomputes its ``pallas_call``).  Gradients reach
whatever leaves the caller marks: ``train.step`` hands in one view per
layer of each stacked leaf, so every layer's gradient is written once.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, mlp_forward, rms_norm
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import (gather_spec, psum,
                                              seq_gather, to_stream)
from repro_torch.tree import map as tree_map


def _rows(embed: torch.Tensor, tokens: torch.Tensor,
          spec: Optional[tuple] = None) -> tuple:
    """(the rows of ``tokens`` in ``embed``, whether they are this
    rank's partial): where ``spec`` makes ``embed`` this rank's block of
    rows over "model", its own tokens' rows and zeros for the others',
    which summed over the ranks are the rows (one holds each, so the
    sum is exact)."""
    mesh = shrules.active_mesh()
    if not shrules.splits(spec, 0, mesh):
        return embed[tokens], False
    rows = embed.shape[0]
    local = tokens - mesh.axis_index("model") * rows
    own = (local >= 0) & (local < rows)
    out = embed[local.clamp(0, rows - 1)] * own[..., None].to(embed.dtype)
    return out, True


def vocab_blocks(fsdp) -> bool:
    """Whether the layout ``fsdp`` (None: whole weights) holds the
    unembedding's vocabulary columns (``lm_head``, or the tied
    ``embed``'s rows) in blocks over "model": a tensor-parallel
    training forward then returns this rank's columns of the logits,
    which the loss takes as they are (``models.common.token_nll``)."""
    if fsdp is None:
        return False
    specs = fsdp.specs
    spec = specs["lm_head"] if "lm_head" in specs else specs["embed"][::-1]
    return shrules.splits(spec, 1, fsdp.mesh)


def _unstack(specs):
    """The specs of one period's slice of stacked leaves: each spec
    without its leading period axis."""
    return tree_map(lambda sp: sp[1:], specs,
                    is_leaf=lambda sp: isinstance(sp, tuple))


def check_ported(cfg: ModelConfig) -> None:
    """Admit the stacks the port runs: attention stacks, GQA (causal or
    not, with or without a modality frontend's stub projection) or MLA,
    whose FFNs are dense MLPs or Mixture-of-Experts, with or without a
    dense prefix; pure Mamba-2 stacks; and the attention/Mamba-2 hybrid
    (``attn_every > 1``, jamba).  A stack whose attention layers have
    no attention flavour the port knows is refused."""
    if cfg.attn_every != 0 and cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs GQA or MLA attention layers "
            f"(attention={cfg.attention!r})")


def _index(tree, j: int):
    """Period ``j`` of a stacked parameter or cache tree (views; a leaf
    given as a list of per-period tensors yields its j-th)."""
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def _layer_forward(lp: dict, cfg: ModelConfig, kinds: tuple, x,
                   positions, layer_cache, cache_len, plan,
                   block_tables=None, impl="auto", aux=False, gather=None,
                   specs=None, seq=False):
    """One layer of ``kinds`` (``cfg.block_kind(i)``,
    ``cfg.ffn_kind(i)``): (x, its MoE aux losses, empty for a dense FFN
    or without ``aux``).  ``gather`` (FSDP): the layer's global weights
    from its blocks ``lp``, gathered here so that a checkpointed layer
    gathers them again in its recompute and frees them after it.
    ``specs`` (the sharded serving state): the layer's leaves' specs,
    which say the sublayers which of ``lp``'s leaves are model-axis
    blocks.  ``seq``: ``x`` is this rank's sequence block of the
    residual stream (``seq_stream``): the norms and residual adds run on
    it, each sublayer's normed input is gathered along the sequence and
    its output comes back as the block (``collectives.to_stream``)."""
    if gather is not None:
        lp = gather(lp)
    specs = specs or {}
    kind, ffn_kind = kinds
    mesh = shrules.active_mesh()

    def normed(x, weight):
        h = rms_norm(x, weight)
        return seq_gather(h, mesh) if seq else h

    h = normed(x, lp["pre_norm"])
    if kind == "mamba":
        h, _ = mb.mamba_forward(
            lp["mamba"], cfg, h,
            cache=None if layer_cache is None else layer_cache["mamba"],
            impl=impl, specs=specs.get("mamba"), seq=seq)
        x = x + h
    else:
        # the attention block owns its residual add: the decode
        # megakernel folds it into the launch, every other path adds it
        # in the block's forward
        x, _ = attn.attention_forward(
            lp["attn"], cfg, h, positions,
            cache=None if layer_cache is None else layer_cache["attn"],
            cache_len=cache_len, block_tables=block_tables, plan=plan,
            residual=x, impl=impl, specs=specs.get("attn"), seq=seq)
    if "ffn_norm" not in lp:
        return x, {}                # pure mamba2: no FFN sublayer
    h = normed(x, lp["ffn_norm"])
    if ffn_kind == "moe" and "moe" in lp:
        h, layer_aux = moe_mod.moe_forward(lp["moe"], cfg, h, aux=aux,
                                           specs=specs.get("moe"), seq=seq)
        return x + h, layer_aux
    return x + mlp_forward(lp["mlp"], h, cfg.mlp, specs.get("mlp"),
                           seq=seq), {}


#: the products ``"dots"`` keeps: JAX's dot_general without batch
#: dimensions, which a 2-D ``x @ W`` reaches as ``aten.mm``
DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat="dots"``: save a
    product without batch dimensions, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if func in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig) -> Optional[dict]:
    """The ``torch.utils.checkpoint`` options around each layer of a
    training forward (``cfg.remat``), or None to keep every
    activation."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {"use_reentrant": False}
    if cfg.remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_policy)}
    raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")


def forward(params: dict, cfg: ModelConfig, tokens=None, embeds=None, *,
            cache: Optional[dict] = None, cache_len=None,
            positions: Optional[torch.Tensor] = None, plan=None,
            block_tables: Optional[torch.Tensor] = None,
            return_aux: bool = False, impl: str = "auto", fsdp=None):
    """tokens: (B, S) integer ids and/or embeds: (B, S_f, frontend_dim)
    (the stub modality frontend, placed before the tokens).
    ``cache``/``cache_len``: KV-cached mode; ``cache_len`` is an int
    (the whole batch at one context) or a (B,) tensor of per-row write
    positions.  ``plan``: a ``lower.runtime.PlanDispatch`` routing every
    attention block.  ``block_tables``: (B, max_pages) int32 page table
    of paged caches, shared by every layer.  ``impl``: the
    ``kernels.ops`` impl of every attention and SSD call (``torch``
    forces the plain versions on the card).  ``fsdp``: a
    ``sharding.fsdp.FSDP`` whose blocks ``params`` are (the training
    layout, or the sharded serving state): each layer's weights, the
    embedding, the unembedding and the final norm are gathered over the
    data axes at their use; the model-axis blocks stay blocks, each
    layer told by the layout's specs which.  A vocabulary block
    (``embed``/``lm_head`` rows over "model") looks up this rank's
    tokens, zeros the others and sums the rows over "model"; its logits
    are gathered over "model" when serving and stay this rank's columns
    in training (:func:`vocab_blocks`); the norms' scales are whole on
    every rank.  An MLA layer's specs hold its latent cache's too.

    Under an active mesh whose rules hold the residual stream as
    sequence blocks (``rules.stream_splits``: JAX's ``seq_stream`` over
    a "model" axis of more than one rank, where S divides it; a decode
    step's S = 1 never does) each rank holds its S/n rows between the
    layers: the embedding's rows are reduce-scattered (a vocabulary
    block's partials; a frontend's rows enter that sum as model rank
    0's) or sliced, every layer runs on its block (``_layer_forward``'s
    ``seq``), and the final norm's output is gathered before the
    unembedding, so the logits have every row.
    Returns logits (B, S_f + S, vocab), plus the cache (updated in
    place) when one is given, plus, with ``return_aux``, the MoE
    auxiliary losses summed over the layers (fp32 zeros for a stack
    without MoE)."""
    check_ported(cfg)
    dt = cfg.torch_dtype()

    def use(key):
        if fsdp is None:
            return params[key]
        return fsdp.gather(params[key], fsdp.param_specs[key])

    # the layout's specs: which leaves are model-axis blocks
    specs = None if fsdp is None else fsdp.specs

    mesh = shrules.active_mesh()
    b = (embeds if tokens is None else tokens).shape[0]
    s = sum(t.shape[1] for t in (embeds, tokens) if t is not None)
    # the residual stream in sequence blocks (JAX's seq_stream), its
    # spec resolved on the global shape: a training layout's rows are
    # the data ranks' blocks of the batch
    rows = b * (1 if fsdp is None or fsdp.serve else
                math.prod(fsdp.mesh.axis_size(a) for a in fsdp.axes))
    seq = mesh is not None and shrules.stream_splits(
        (rows, s, cfg.d_model), mesh)
    parts, partial = [], False
    if embeds is not None:
        parts.append(embeds.to(dt) @ use("frontend_proj").to(dt))
    if tokens is not None:
        found, partial = _rows(use("embed").to(dt), tokens,
                               specs and specs["embed"])
        if partial and not seq:
            found, partial = psum(found, mesh, "model"), False
        if partial and parts:
            # the frontend's rows, whole on every rank, enter the
            # ranks' sum as model rank 0's
            parts[0] = parts[0] * float(mesh.axis_index("model") == 0)
        parts.append(found)
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    x = to_stream(x, mesh, partial=partial, seq=seq)
    if positions is None:
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
            positions = cache_len.to(torch.int32)[:, None] + ar[None, :]
        else:
            start = 0 if cache_len is None else int(cache_len)
            positions = (start + ar)[None, :].expand(b, s)

    remat = _remat(cfg) if cache is None and torch.is_grad_enabled() \
        else None

    # the recompute runs under the forward's mesh, in whatever thread
    layer_fn = shrules.under_active_rules(_layer_forward)

    def layer(i, lp, lc, x, gather, ls=None):
        kind = (cfg.block_kind(i), cfg.ffn_kind(i))
        if remat is not None:
            return checkpoint(layer_fn, lp, cfg, kind, x, positions,
                              None, None, plan, None, impl, return_aux,
                              gather, ls, seq, **remat)
        return _layer_forward(lp, cfg, kind, x, positions, lc, cache_len,
                              plan, block_tables, impl, return_aux, gather,
                              ls, seq)

    if fsdp is None:
        prefix_gather = [None] * len(params["prefix_layers"])
        body_gather = [None] * cfg.layer_period
    else:
        prefix_gather = [functools.partial(fsdp.gather_tree, specs=s)
                         for s in fsdp.param_specs["prefix_layers"]]
        # a stacked leaf's spec leads with its period axis's None
        body_gather = [functools.partial(fsdp.gather_tree, specs=_unstack(s))
                       for s in fsdp.param_specs["layers"]]
    prefix_specs = [None] * len(params["prefix_layers"]) if specs is None \
        else specs["prefix_layers"]
    body_specs = [None] * cfg.layer_period if specs is None \
        else [_unstack(s) for s in specs["layers"]]

    aux = []                            # each layer's aux losses
    for i, lp in enumerate(params["prefix_layers"]):
        x, la = layer(i, lp, None if cache is None else cache["prefix"][i],
                      x, prefix_gather[i], prefix_specs[i])
        aux.append(la)
    for j in range(cfg.n_periods):
        for pos in range(cfg.layer_period):
            lc = None if cache is None else _index(cache["scan"][pos], j)
            x, la = layer(cfg.first_dense_layers + pos,
                          _index(params["layers"][pos], j), lc, x,
                          body_gather[pos], body_specs[pos])
            aux.append(la)

    x = rms_norm(x, use("final_norm"))
    if seq:
        x = seq_gather(x, mesh)
    head = use("lm_head").to(dt) if "lm_head" in params \
        else use("embed").to(dt).T
    logits = x @ head
    if vocab_blocks(fsdp) and not fsdp.model_ranks > 1:
        # this rank's vocabulary columns: every rank's, in rank order
        logits = gather_spec(logits, (None, None, "model"), mesh)
    out = [logits] if cache is None else [logits, cache]
    if return_aux:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        out.append({key: sum((la[key] for la in aux if key in la), zero)
                    for key in ("moe_lb_loss", "moe_z_loss")})
    return out[0] if len(out) == 1 else tuple(out)


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed caches in the parameter tree's layout: a list for the
    prefix layers, ``n_periods``-stacked tensors for the body.  An
    attention layer holds ``{"attn": {"k", "v"}}`` (``max_len`` rows) or,
    for MLA, ``{"attn": {"latent"}}`` (``max_len`` latent rows), a mamba
    layer ``{"mamba": {"conv", "ssm"}}`` (the SSM state fp32)."""
    check_ported(cfg)

    def layer(i, lead=()):
        if cfg.block_kind(i) == "attn":
            return {"attn": attn.init_cache(cfg, batch, max_len, dtype,
                                            device, lead)}
        return {"mamba": mb.init_mamba_cache(cfg, batch, dtype, device,
                                             lead)}
    return {"prefix": [layer(i) for i in range(cfg.first_dense_layers)],
            "scan": [layer(cfg.first_dense_layers + pos, (cfg.n_periods,))
                     for pos in range(cfg.layer_period)]}
