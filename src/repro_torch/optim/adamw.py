"""AdamW, the cosine schedule and global-norm clipping: a copy of
``repro/optim/adamw.py`` over torch tensor trees, with the same fp32
math and casts.

The moment dtype is configurable: bf16 moments halve the optimizer's
memory, which is what lets starcoder2-7b's training state (14.3 GB of
bf16 parameters, as much again of gradients) fit on one 80 GB card.

Unlike the JAX package's functional update, :func:`adamw_update` writes
the new parameters and moments into the given tensors, a bounded chunk
at a time (:data:`CHUNK` elements along the leading axis), so no fp32
copy of a whole stacked leaf (10.9 GB for starcoder2-7b's ``w_up``) is
ever made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.sharding.collectives import psum
from repro_torch.sharding.rules import sharded_axes

#: elements of a leaf updated at once (fp32 temporaries of ~256 MB)
CHUNK = 1 << 26


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor      # () int32, on the parameters' device
    mu: Any
    nu: Any


def adamw_init(params, moment_dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, moment_dtype)
    first = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree.map(zeros, params), nu=tree.map(zeros, params))


def chunks(t: torch.Tensor) -> list:
    """Views of ``t`` along its leading axis, each at most :data:`CHUNK`
    elements (a whole stacked period, or rows of a table)."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        return [t]
    row = t.numel() // t.shape[0]
    return list(t.split(max(1, CHUNK // row), dim=0))


def global_norm(grads, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32.  With
    ``shardings`` (a tree of ``NamedSharding``, the gradients being
    blocks), each leaf's sum of squares is summed over the mesh axes
    its spec splits it over, and over none for a whole leaf, so the norm
    is the global tree's."""
    leaves = tree.leaves(grads)
    shards = ([None] * len(leaves) if shardings is None
              else tree.leaves(shardings))
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, sh in zip(leaves, shards):
        axes = sharded_axes(sh)
        if not axes:                    # a whole leaf
            for c in chunks(g):
                total = total + c.float().square().sum()
            continue
        part = torch.zeros_like(total)
        for c in chunks(g):
            part = part + c.float().square().sum()
        total = total + psum(part, sh.mesh, axes)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm`` and
    rounded back to their dtypes, the norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0, shardings=None):
    """One AdamW step.  ``lr`` may be a scalar or a schedule(step).
    Updates ``params`` and the moments in place and returns (params,
    state, {"grad_norm", "lr"}) as the JAX package returns its new
    ones.  ``shardings`` (FSDP: every tensor a block): the gradient
    norm is the global tree's (:func:`global_norm`); the update is
    elementwise, so each block updates where it lives."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    gnorm = global_norm(grads, shardings)
    limit = math.inf if max_grad_norm is None else max_grad_norm
    scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-9), max=1.0)

    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, mu, nu):
        gf = (g.float() * scale).to(g.dtype).float()
        mu_n = b1 * mu.float() + (1 - b1) * gf
        nu_n = b2 * nu.float() + (1 - b2) * gf * gf
        mhat = mu_n / c1
        vhat = nu_n / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
        mu.copy_(mu_n)
        nu.copy_(nu_n)

    for p, g, mu, nu in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(state.mu), tree.leaves(state.nu)):
        for cs in zip(chunks(p), chunks(g), chunks(mu), chunks(nu)):
            upd(*cs)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr_t}


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
