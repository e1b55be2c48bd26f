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

Under an active mesh (``sharding.set_rules_for_mesh``) whose data axes
("pod", "data") span more than one rank, the step is data-parallel: each
rank takes its block of the batch's rows, and the gradients are averaged
over those axes (``psum`` / n, in fp32) before the int8 compression, the
clipping and AdamW, so the gradient norm, the error feedback and the
update see the global gradient, as they do under JAX's GSPMD.  The
parameters stay replicated on every rank (JAX's FSDP shard of "embed"
over data is a layout without a numeric effect).  The loss and the MoE
aux metrics are the ranks' mean; with MoE FFNs the aux losses are each
rank's own tokens' (moe_local_dispatch's per-shard semantics), where
GSPMD computes them over the global batch.
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
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.models.weights import init_params
from repro_torch.optim import (adamw_init, adamw_update,
                               error_feedback_init,
                               int8_compress_with_feedback)
from repro_torch.optim.adamw import AdamWState, chunks
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import pmean


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
    ``params_from_numpy``), else random ones drawn from ``generator``
    on ``device``; zero moments in ``moment_dtype``."""
    if params is None:
        params = init_params(cfg, generator, device)
    fb = error_feedback_init(params) if grad_compression else None
    return TrainState(params=params, opt=adamw_init(params, moment_dtype),
                      feedback=fb)


def loss_fn(params, cfg: ModelConfig, batch, *, impl: str = "auto"):
    """Next-token cross entropy plus 0.01 times the MoE load-balance
    loss and 0.001 times its z-loss, each summed over the layers (zero
    for a stack without MoE); the metrics report the three terms.  batch: {"tokens": (B, S+1)} integer ids on the parameters'
    device, or with a stub frontend {"embeds", "tokens"} (the VLM: the
    loss covers the text suffix only) or {"embeds", "targets"} (the
    encoder); optional "mask" (B, S) and, for a non-causal model,
    "targets"."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    if tokens is not None and cfg.causal:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs, targets = tokens, batch.get("targets", tokens)
    logits, aux = tf.forward(params, cfg, inputs, embeds, return_aux=True,
                             impl=impl)
    if embeds is not None and tokens is not None:
        logits = logits[:, -targets.shape[1]:]
    loss = cross_entropy(logits, targets, batch.get("mask"))
    total = loss + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_z_loss"]
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
                   impl: str = "auto"):
    """((total loss, metrics), gradients): the gradients in the
    parameters' tree, layout and dtypes, each layer's written once into
    its slice."""
    grads = tree.map(torch.zeros_like, params)
    leaves = _trainable(params, grads)
    with torch.enable_grad():
        total, metrics = loss_fn(leaves, cfg, batch, impl=impl)
        total.backward()
    return (total.detach(), metrics), grads


def train_step(state: TrainState, batch, cfg: ModelConfig, *,
               lr=3e-4, weight_decay: float = 0.1,
               microbatches: int = 1, impl: str = "auto") -> tuple:
    """One optimizer step, updating ``state`` in place and returning it
    with the metrics.  ``microbatches`` > 1 accumulates the gradients of
    leading-batch slices in fp32 and divides, as the JAX package does;
    the metrics are the last slice's."""
    params = state.params
    mesh, data_axes = _data_parallel()
    if data_axes:
        batch = _local_rows(batch, mesh, data_axes)
    if microbatches > 1:
        n = next(iter(batch.values())).shape[0] // microbatches
        acc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            (_, metrics), g = value_and_grad(params, cfg, mb, impl=impl)
            for a, x in zip(tree.leaves(acc), tree.leaves(g)):
                for ca, cx in zip(chunks(a), chunks(x)):
                    ca.add_(cx.float())
            del g
        for a in tree.leaves(acc):
            a.div_(microbatches)
        grads = acc
    else:
        (_, metrics), grads = value_and_grad(params, cfg, batch, impl=impl)

    if data_axes:
        for g in tree.leaves(grads):
            g.copy_(pmean(g.float(), mesh, data_axes))
        metrics = {k: pmean(v, mesh, data_axes) for k, v in metrics.items()}

    feedback = state.feedback
    if feedback is not None:
        grads, feedback = int8_compress_with_feedback(grads, feedback)

    params, opt, opt_metrics = adamw_update(
        params, grads, state.opt, lr=lr, weight_decay=weight_decay)
    metrics = dict(metrics, **opt_metrics)
    return TrainState(params=params, opt=opt, feedback=feedback), metrics


def _data_parallel() -> tuple:
    """(the active mesh, its data axes of more than one rank)."""
    mesh = shrules.active_mesh()
    if mesh is None:
        return None, ()
    return mesh, tuple(a for a in ("pod", "data")
                       if a in mesh.axis_names and mesh.axis_size(a) > 1)


def _local_rows(batch: dict, mesh, data_axes: tuple) -> dict:
    """This rank's block of the batch's rows over ``data_axes``."""
    if "mask" in batch:
        raise NotImplementedError(
            "a masked batch under a data mesh: the loss's token mean "
            "would be each rank's, not the global batch's")
    spec = (data_axes,)
    return {k: shrules.local_slice(v, spec, mesh) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, **kw) -> Callable:
    """``train_step`` with the config and options bound."""
    return functools.partial(train_step, cfg=cfg, **kw)
