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
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.collectives import all_gather, to_stream


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


def _block(t: torch.Tensor, split: bool, rank: int, n: int,
           dim: int = -1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` where ``split``, else
    ``t``."""
    if not split:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  cache: Optional[dict] = None, impl: str = "auto",
                  specs: Optional[dict] = None, seq: bool = False):
    """x: (B, L, D).  ``cache`` {"conv", "ssm"}: updated in place.
    ``impl``: the ``ops.ssd`` impl (``torch`` forces the plain version
    on the card).

    ``specs`` (the sharded serving state, ``serve/layout.py``, or the
    tensor-parallel training layout, ``train/step.py``): the
    leaves' specs, each saying whether its leaf is this rank's block
    over "model": ``in_proj``'s columns, the conv channels (``conv_w``,
    ``conv_b`` and the conv tail, which share their width), the SSM
    heads (``a_log``, ``d_skip``, ``dt_bias`` and the SSM state) and
    ``inner`` (``norm`` and ``out_proj``'s rows), each whole where its
    width does not divide the axis.  The rank gathers the in-projection
    over "model", convolves its own channels with its own tail (the conv
    is depthwise) and gathers them, scans its heads over the B/C of the
    groups they fall in (the one group its heads lie in, its whole
    groups, or else a group per head), gates its ``inner`` block, takes
    the norm's sum of squares over "model" (``rms_norm(mesh=)``) and
    sums the out-projection's partials with one ``psum``.  Both gathers
    are ``collectives.all_gather``, whose backward sums the ranks'
    shares of the gathered cotangent and keeps the rank's own block, so
    training takes the same path.  ``seq`` (``seq_stream``): ``x`` is
    the whole sequence, gathered from the ranks' blocks (the conv and
    the scan run on it), and the out-projection's partials are
    reduce-scattered to this rank's block instead of summed, or a whole
    output sliced to it (``collectives.to_stream``).  Returns (out (B,
    L, D), or its block, the cache or None)."""
    dt_ = x.dtype
    bsz, length, _ = x.shape
    d_in, h, p, g, s = dims(cfg)
    mesh = shrules.active_mesh()
    n, r = (mesh.axis_size("model"), mesh.axis_index("model")) \
        if mesh is not None and "model" in mesh.axis_names else (1, 0)
    # which leaves are this rank's blocks, by the layout's specs
    proj_split = shrules.splits(specs and specs["in_proj"], 1, mesh)
    conv_split = shrules.splits(specs and specs["conv_w"], 1, mesh)
    head_split = shrules.splits(specs and specs["a_log"], 0, mesh)
    inner_split = shrules.splits(specs and specs["out_proj"], 0, mesh)

    zxbcdt = x @ params["in_proj"].to(dt_)
    if proj_split:
        zxbcdt = all_gather(zxbcdt, (None, None, "model"), mesh)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * s]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - h:]
    xbc, new_conv = _conv1d(_block(xbc, conv_split, r, n),
                            params["conv_w"].to(dt_),
                            params["conv_b"].to(dt_),
                            None if cache is None else cache["conv"])
    xbc = F.silu(xbc.float()).to(dt_)
    if conv_split:
        xbc = all_gather(xbc, (None, None, "model"), mesh)
    h_l = h // n if head_split else h
    h0 = r * h_l if head_split else 0
    xs = xbc[..., h0 * p:(h0 + h_l) * p].reshape(bsz, length, h_l, p)
    bmat = xbc[..., d_in:d_in + g * s].reshape(bsz, length, g, s)
    cmat = xbc[..., d_in + g * s:].reshape(bsz, length, g, s)
    if head_split:
        per_group = h // g
        g0 = h0 // per_group
        if (h0 + h_l - 1) // per_group == g0:
            g_l = 1                 # the rank's heads inside one group
        elif h0 % per_group == 0 and h_l % per_group == 0:
            g_l = h_l // per_group  # whole groups
        else:
            g_l = 0                 # a group parted: one per head
        if g_l:
            bmat = bmat[:, :, g0:g0 + g_l]
            cmat = cmat[:, :, g0:g0 + g_l]
        else:
            idx = torch.arange(h0, h0 + h_l, device=x.device) // per_group
            bmat = bmat.index_select(2, idx)
            cmat = cmat.index_select(2, idx)
        dt_raw = dt_raw[..., h0:h0 + h_l]
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
    y = y.reshape(bsz, length, h_l * p)
    # the rank's heads are its inner block: d_in = H P, so where the
    # heads divide the axis inner does too (not the other way round)
    assert inner_split or not head_split
    if inner_split and not head_split:
        y = _block(y, True, r, n)
    y = y * F.silu(_block(z, inner_split, r, n).float()).to(dt_)
    y = rms_norm(y, params["norm"], mesh=mesh if inner_split else None,
                 width=d_in)
    out = y @ params["out_proj"].to(dt_)
    return to_stream(out, mesh, partial=inner_split, seq=seq), cache


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
