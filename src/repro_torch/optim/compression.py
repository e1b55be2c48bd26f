"""int8 gradient compression with error feedback: a copy of
``repro/optim/compression.py`` over torch tensor trees.  The gradient is
quantised to int8 with a per-tensor scale, and the quantisation
residual is kept in an fp32 buffer that is added back next step, so the
compression stays unbiased over time."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.sharding.collectives import pmax
from repro_torch.sharding.rules import sharded_axes


def error_feedback_init(params) -> Any:
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_int8(x, sharding=None):
    """(int8 values, the per-tensor scale).  With ``sharding`` (``x`` a
    block), the scale is the whole tensor's: the max-abs over the mesh
    axes the block's spec splits it over."""
    amax = x.abs().max()
    axes = sharded_axes(sharding)
    if axes:
        amax = pmax(amax, sharding.mesh, axes)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g, sharding=None):
    """int8 round-trip of one tensor (the wire format)."""
    q, scale = _quant_int8(g.float(), sharding)
    return q.float() * scale


@torch.no_grad()
def int8_compress_with_feedback(grads, feedback, shardings=None):
    """g' = Q(g + e);  e' = (g + e) - g'.  ``shardings`` (FSDP: blocks):
    each leaf's scale is its whole tensor's."""
    def one(g, e, sh):
        corrected = g.float() + e
        sent = compress_decompress(corrected, sh)
        return sent.to(g.dtype), corrected - sent
    leaves = tree.leaves(grads)
    shards = ([None] * len(leaves) if shardings is None
              else tree.leaves(shardings))
    out = [one(g, e, sh) for g, e, sh in zip(leaves, tree.leaves(feedback),
                                             shards)]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(feedback, [o[1] for o in out]))
