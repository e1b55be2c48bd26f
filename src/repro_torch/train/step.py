"""Training step of the port: loss -> gradients -> AdamW, with optional
gradient accumulation (microbatching) and int8 gradient compression: a
copy of ``repro/train/step.py``.

JAX differentiates a pure function of the parameter tree.  Here
:func:`value_and_grad` hands the model one trainable view per layer of
each stacked leaf (``layers`` leaves carry a leading ``n_periods``
axis), sharing the stacked storage, with its ``.grad`` preset to the
matching slice of a zeroed stacked gradient buffer: autograd then adds
each layer's gradient into its slice in place, once.  Differentiating
the stacked leaf itself would make every period's ``select`` backward
allocate a zero tensor of the whole stacked leaf (5.4 GB for
starcoder2-7b's ``w_up``) per layer.  The gradient tree comes back in
the JAX package's layout.

Under an active mesh (``sharding.set_rules_for_mesh``) of more than one
rank, the step runs on the JAX package's layout under GSPMD
(:func:`fsdp_layout`, ``sharding/fsdp.py``; ``launch.train.build``
places the blocks): FSDP (ZeRO-3) over the data axes ("pod", "data"),
and tensor parallelism over "model" (attention heads, KV heads,
Mamba-2's ``inner``, ``ssm_heads`` and conv channels, MLP columns,
vocabulary rows and experts, where they divide), for every stack.
Each rank runs its data axes' block of the batch's rows (every rank of
"model" the same rows); the model gathers each layer's weights over the
data axes at their use and reduce-scatters their gradients back to the
blocks, averaged over the data ranks in fp32, and computes on its
model-axis blocks, which it never gathers: the attention (GQA or MLA)
on its heads, the Mamba-2 block on its channels and SSM heads, the MLP
on its columns, the MoE on its experts, the logits on its vocabulary
columns, whose cross entropy ``token_nll(mesh=)`` takes without
gathering them.  Between the layers each rank of "model" holds its
block of the residual stream's sequence where the sequence divides the
axis (JAX's ``seq_stream``, ``models/transformer.py``): the norms and
residual adds run on it, each sublayer all-gathers its normed input
along the sequence and reduce-scatters its output partials.  Every
rank computes the global batch's loss through differentiable
``psum``/``pmean``: the token mean over the
global batch (with a mask, the ranks' masked sums over their summed
token counts), the MoE load balance from global means
(``models/moe.py``) and the z-loss as the ranks' mean; the metrics are
those global values.  Each rank of "model" takes its share of the
loss's cotangent (``collectives.leave``), as ``sharding/collectives.py``
sets out.  The gradient norm, the int8 scales and AdamW run on the
blocks, each reading its leaf's global values where it needs them
(``optim/``).  Microbatches are slices of the global batch, each rank
taking its rows of each, as JAX slices its global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
# torch.utils.checkpoint imports torch._dynamo at its first call, and an
# exception raised and caught inside that import keeps the calling
# stack's frames in a reference cycle until the garbage collector runs.
# Inside the first training forward those frames would pin that step's
# gradients (14.8 GB for starcoder2-7b) into the next step; imported
# here, the cycle holds only this module's import.
import torch._dynamo  # noqa: F401

from repro_torch import tree
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, cross_entropy, token_nll
from repro_torch.models.weights import init_params, param_axes
from repro_torch.optim import (adamw_init, adamw_update,
                               error_feedback_init,
                               int8_compress_with_feedback)
from repro_torch.optim.adamw import AdamWState, chunks
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import leave, pmean, psum
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.rules import NamedSharding


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    feedback: Optional[Any] = None     # error-feedback buffers (compression)


def init_train_state(generator: Optional[torch.Generator],
                     cfg: ModelConfig, *, moment_dtype: str = "float32",
                     grad_compression: bool = False, device="cuda",
                     params=None) -> TrainState:
    """A fresh state: ``params`` if given (e.g. the JAX package's, through
    ``params_from_numpy``, or FSDP blocks), else random ones drawn from
    ``generator`` on ``device``; zero moments in ``moment_dtype``, of
    the parameters' shapes."""
    if params is None:
        params = init_params(cfg, generator, device)
    fb = error_feedback_init(params) if grad_compression else None
    return TrainState(params=params, opt=adamw_init(params, moment_dtype),
                      feedback=fb)


@functools.lru_cache(maxsize=8)
def fsdp_layout(cfg: ModelConfig, mesh) -> Optional[FSDP]:
    """The blocks of ``cfg``'s training state on ``mesh``:
    ``param_shardings`` of the parameters' logical axes on their global
    shapes, laid out on the meta device, over the data axes and
    "model"; None without a mesh and on a mesh of one rank (the
    single-card step)."""
    if mesh is None or mesh.size == 1:
        return None
    return FSDP(mesh, param_axes(cfg), init_params(cfg, None, "meta"))


def state_shardings(state: TrainState, fsdp: FSDP) -> TrainState:
    """A tree of ``state``'s structure holding each leaf's
    ``NamedSharding``: the parameters' for the parameters, the moments
    and the error feedback; the step whole."""
    sh = fsdp.shardings()
    return TrainState(
        params=sh, opt=AdamWState(step=NamedSharding(fsdp.mesh, ()),
                                  mu=sh, nu=sh),
        feedback=None if state.feedback is None else sh)


def whole_state(state: TrainState, fsdp: FSDP, *, device=None,
                keep: bool = True) -> Optional[TrainState]:
    """The global tensors of a state of blocks, leaf by leaf on
    ``device`` (default: each leaf's); every rank calls it, and a rank
    that does not ``keep`` them (``FSDP.full``) gets None."""
    full = functools.partial(fsdp.full, device=device, keep=keep)
    whole = TrainState(
        params=full(state.params),
        opt=AdamWState(step=state.opt.step, mu=full(state.opt.mu),
                       nu=full(state.opt.nu)),
        feedback=None if state.feedback is None else full(state.feedback))
    return whole if keep else None


def loss_fn(params, cfg: ModelConfig, batch, *, impl: str = "auto",
            fsdp: Optional[FSDP] = None):
    """Next-token cross entropy plus 0.01 times the MoE load-balance
    loss and 0.001 times its z-loss, each summed over the layers (zero
    for a stack without MoE); the metrics report the three terms.  batch: {"tokens": (B, S+1)} integer ids on the parameters'
    device, or with a stub frontend {"embeds", "tokens"} (the VLM: the
    loss covers the text suffix only) or {"embeds", "targets"} (the
    encoder); optional "mask" (B, S) and, for a non-causal model,
    "targets".  ``fsdp``: ``params`` are its blocks and ``batch`` this
    rank's rows of the global batch, whose loss every rank returns (on
    a tensor-parallel layout from its vocabulary columns of the
    logits)."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    if tokens is not None and cfg.causal:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs, targets = tokens, batch.get("targets", tokens)
    logits, aux = tf.forward(params, cfg, inputs, embeds, return_aux=True,
                             impl=impl, fsdp=fsdp)
    if embeds is not None and tokens is not None:
        logits = logits[:, -targets.shape[1]:]
    mask = batch.get("mask")
    if fsdp is None:
        loss = cross_entropy(logits, targets, mask)
    else:
        mesh, axes = fsdp.mesh, fsdp.axes
        nll = token_nll(logits, targets,
                        mesh if tf.vocab_blocks(fsdp) and fsdp.model_ranks > 1
                        else None)
        if mask is None:                # equal rows: the ranks' mean
            loss = pmean(nll.mean(), mesh, axes)
        else:
            loss = psum((nll * mask).sum(), mesh, axes) / torch.clamp(
                psum(mask.sum().float(), mesh, axes), min=1.0)
        aux = dict(aux, moe_z_loss=pmean(aux["moe_z_loss"], mesh, axes))
    total = loss + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_z_loss"]
    if fsdp is not None and fsdp.model_ranks > 1:
        # every model rank computes the loss whole: each backward takes
        # its share (sharding/collectives.py)
        total = leave(total, fsdp.mesh, "model")
    metrics = {"loss": loss.detach(),
               "moe_lb_loss": aux["moe_lb_loss"].detach(),
               "moe_z_loss": aux["moe_z_loss"].detach()}
    return total, metrics


def _trainable(params, grads):
    """The tree the model is run on: for every leaf a trainable view of
    its storage whose ``.grad`` is the matching view of ``grads``; a
    stacked ``layers`` leaf becomes a list of per-period views."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def stacked(p, g):
        return [leaf(p[j], g[j]) for j in range(p.shape[0])]

    return {key: ([tree.map(stacked, lp, lg)
                   for lp, lg in zip(val, grads[key])]
                  if key == "layers" else tree.map(leaf, val, grads[key]))
            for key, val in params.items()}


def value_and_grad(params, cfg: ModelConfig, batch, *,
                   impl: str = "auto", fsdp: Optional[FSDP] = None):
    """((total loss, metrics), gradients): the gradients in the
    parameters' tree, layout and dtypes, each layer's written once into
    its slice.  With ``fsdp``, ``params`` and the gradients are blocks,
    each block's gradient the data ranks' mean of theirs."""
    grads = tree.map(torch.zeros_like, params)
    leaves = _trainable(params, grads)
    with torch.enable_grad():
        total, metrics = loss_fn(leaves, cfg, batch, impl=impl, fsdp=fsdp)
        total.backward()
    return (total.detach(), metrics), grads


def train_step(state: TrainState, batch, cfg: ModelConfig, *,
               lr=3e-4, weight_decay: float = 0.1,
               microbatches: int = 1, impl: str = "auto") -> tuple:
    """One optimizer step, updating ``state`` in place and returning it
    with the metrics.  ``microbatches`` > 1 accumulates the gradients of
    leading-batch slices in fp32 and divides, as the JAX package does;
    the metrics are the last slice's.  Under a mesh ``state`` holds
    this rank's blocks (:func:`fsdp_layout`) and ``batch`` is the
    global batch."""
    params = state.params
    fsdp = fsdp_layout(cfg, shrules.active_mesh())
    if fsdp is not None:
        fsdp.check_blocks(params)

    def rows(b):
        if fsdp is None:
            return b
        return {k: shrules.local_slice(v, (fsdp.axes,), fsdp.mesh)
                for k, v in b.items()}

    if microbatches > 1:
        n = next(iter(batch.values())).shape[0] // microbatches
        acc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatches):
            mb = rows({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            (_, metrics), g = value_and_grad(params, cfg, mb, impl=impl,
                                             fsdp=fsdp)
            for a, x in zip(tree.leaves(acc), tree.leaves(g)):
                for ca, cx in zip(chunks(a), chunks(x)):
                    ca.add_(cx.float())
            del g
        for a in tree.leaves(acc):
            a.div_(microbatches)
        grads = acc
    else:
        (_, metrics), grads = value_and_grad(params, cfg, rows(batch),
                                             impl=impl, fsdp=fsdp)

    shardings = None if fsdp is None else fsdp.shardings()
    feedback = state.feedback
    if feedback is not None:
        grads, feedback = int8_compress_with_feedback(grads, feedback,
                                                      shardings)

    params, opt, opt_metrics = adamw_update(
        params, grads, state.opt, lr=lr, weight_decay=weight_decay,
        shardings=shardings)
    metrics = dict(metrics, **opt_metrics)
    return TrainState(params=params, opt=opt, feedback=feedback), metrics


def make_train_step(cfg: ModelConfig, **kw) -> Callable:
    """``train_step`` with the config and options bound."""
    return functools.partial(train_step, cfg=cfg, **kw)
