"""Mamba-2 block of the port (``repro/models/mamba.py``): mamba2-130m.

Block: in_proj -> [z | xBC | dt]; causal depthwise conv on xBC; SSD on
(x, B, C, dt) through ``kernels.ops.ssd`` (kernel #11 on the card);
gated by silu(z); RMSNorm; out_proj.  Decode caches: the conv tail (the
last W-1 inputs) and the SSM state (B, H, P, S), fp32 whatever the
cache dtype.

As in the JAX package: a cache-free call scans from a zero state; a
cached multi-token call (a prefill chunk) seeds the scan with the
cached state; a cached one-token call (decode, or a one-token last
prefill chunk) takes ``ssd_step``.  dt is cast to the compute dtype
before the scan but handed to ``ssd_step`` in fp32.  Unlike the JAX
package, the cache is updated in place and the same dict is returned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, rms_norm


def dims(cfg: ModelConfig) -> tuple:
    """(d_inner, heads, head width P, groups G, state S)."""
    d_in = cfg.inner_dim
    heads = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
    return d_in, heads, d_in // heads, cfg.ssm_groups, cfg.ssm_state


def _conv1d(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            cache: Optional[torch.Tensor]):
    """Causal depthwise conv of width W in xbc's dtype: the W products
    summed in order i = 0..W-1, then the bias.  xbc: (B, L, C); w: (W,
    C); cache: (B, W-1, C) previous tail or None.  Returns (out, the new
    tail: the last W-1 rows of [tail | xbc])."""
    width, length = w.shape[0], xbc.shape[1]
    if cache is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    else:
        pad = cache.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                   # (B, L+W-1, C)
    out = full[:, 0:length] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + length] * w[i]
    return out + b, full[:, full.shape[1] - (width - 1):]


def mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  cache: Optional[dict] = None, impl: str = "auto"):
    """x: (B, L, D).  ``cache`` {"conv", "ssm"}: updated in place.
    ``impl``: the ``ops.ssd`` impl (``torch`` forces the plain version
    on the card).  Returns (out (B, L, D), the cache or None)."""
    dt_ = x.dtype
    bsz, length, _ = x.shape
    d_in, h, p, g, s = dims(cfg)

    zxbcdt = x @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * s]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - h:]
    xbc, new_conv = _conv1d(xbc, params["conv_w"].to(dt_),
                            params["conv_b"].to(dt_),
                            None if cache is None else cache["conv"])
    xbc = F.silu(xbc.float()).to(dt_)
    xs = xbc[..., :d_in].reshape(bsz, length, h, p)
    bmat = xbc[..., d_in:d_in + g * s].reshape(bsz, length, g, s)
    cmat = xbc[..., d_in + g * s:].reshape(bsz, length, g, s)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())

    if cache is not None and length == 1:
        y, new_state = ops.ssd_step(xs[:, 0], dt[:, 0], a, bmat[:, 0],
                                    cmat[:, 0], params["d_skip"],
                                    cache["ssm"])
        y = y[:, None]                                    # (B, 1, H, P)
    elif cache is not None:
        # chunked prefill: seed the scan with the cached state
        y, new_state = ops.ssd(xs, dt.to(dt_), a, bmat, cmat,
                               params["d_skip"], chunk=cfg.ssd_chunk,
                               impl=impl, h0=cache["ssm"],
                               return_final_state=True)
    else:
        y = ops.ssd(xs, dt.to(dt_), a, bmat, cmat, params["d_skip"],
                    chunk=cfg.ssd_chunk, impl=impl)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_state)
    y = y.reshape(bsz, length, d_in)
    y = y * F.silu(z.float()).to(dt_)
    y = rms_norm(y, params["norm"])
    return y @ params["out_proj"].to(dt_), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     lead: tuple = ()) -> dict:
    """Zeroed decode caches, with ``lead`` leading axes (the stacked
    body's ``n_periods``): the conv tail in ``dtype``, the state fp32."""
    d_in, h, p, g, s = dims(cfg)
    conv_dim = d_in + 2 * g * s
    return {"conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                                 conv_dim), dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, h, p, s),
                               dtype=torch.float32, device=device)}
