"""int8 gradient compression with error feedback: a copy of
``repro/optim/compression.py`` over torch tensor trees.  The gradient is
quantised to int8 with a per-tensor scale, and the quantisation
residual is kept in an fp32 buffer that is added back next step, so the
compression stays unbiased over time."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree


def error_feedback_init(params) -> Any:
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_int8(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g):
    """int8 round-trip of one tensor (the wire format)."""
    q, scale = _quant_int8(g.float())
    return q.float() * scale


@torch.no_grad()
def int8_compress_with_feedback(grads, feedback):
    """g' = Q(g + e);  e' = (g + e) - g'."""
    def one(g, e):
        corrected = g.float() + e
        sent = compress_decompress(corrected)
        return sent.to(g.dtype), corrected - sent
    out = [one(g, e) for g, e in zip(tree.leaves(grads),
                                     tree.leaves(feedback))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(feedback, [o[1] for o in out]))
