"""``ssd_scan``: the Mamba-2 chunked SSD (state-space duality) scan, as a
CUDA kernel for Hopper (``csrc/ssd_scan.cu``) with its plain PyTorch
version, and ``ssd_step``, the one-token decode update.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py`` ``ssd_scan``.  Per
head, over chunks of ``chunk`` positions, all in fp32:

    cum_t   = sum_{s<=t} a * dt_s                (within the chunk)
    L[t,s]  = exp(cum_t - cum_s) * dt_s          for s <= t, else 0
    y       = ((C B^T) o L) X + exp(cum_t) (C . h) + d * x
    h'      = exp(cum_last) h + X^T (B * exp(cum_last - cum_t) dt_t)

The plain version is the JAX package's ``xla_fallback.chunked_ssd`` (the
function the JAX serve path computes, with an initial state ``h0``), and
the kernel follows it where the TPU kernel rounds differently: ``a * dt``
and the decay stay in fp32, and ``d * x`` is added in fp32 before the one
cast to x's dtype.  The upper triangle of ``cum_t - cum_s`` is zeroed
before ``exp`` (it is positive and would overflow; inf * 0 is NaN).  A
ragged last chunk is masked, not padded: past L, dt counts as 0, so the
state is that after the last position, as with the JAX zero padding.

No impl differentiates: the TPU kernel has no backward, so the wrapper
raises ``NotImplementedError`` on an input that requires grad with
autograd on, on either device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: the kernel's limits (csrc/ssd_scan.cu kMaxP, kMaxS, kMaxChunk)
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 128
#: rows of the decay-score matrix held in shared memory at once
ROW_BLOCK = 32
SMEM_LIMIT = 232448          # bytes of shared memory one block may use


def check_no_grad(name: str, tensors: dict) -> None:
    """Refuse, on any device, an input that autograd would track."""
    if torch.is_grad_enabled():
        tracked = [k for k, t in tensors.items()
                   if t is not None and t.requires_grad]
        if tracked:
            raise NotImplementedError(
                f"{name}: {tracked} require grad, but the SSD scan has no "
                "backward (the JAX package's ssd_scan kernel has none); "
                "call it under torch.no_grad()")


def _pad_seq(t: torch.Tensor, length: int) -> torch.Tensor:
    pad = length - t.shape[1]
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))],
                     dim=1)


def ssd_scan_plain(x, dt, a, b, c, d=None, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None,
                   return_final_state: bool = False):
    """The plain version (``repro/kernels/xla_fallback.py``
    ``chunked_ssd``): the arrays zero-padded to a chunk multiple, the
    groups repeated over the heads, one chunk at a time.
    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, S)."""
    bsz, length, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    rep = h // g
    nj = -(-length // chunk)
    lp = nj * chunk
    xc = _pad_seq(x, lp).float().reshape(bsz, nj, chunk, h, p)
    dtc = _pad_seq(dt, lp).float().reshape(bsz, nj, chunk, h)
    bc = _pad_seq(b, lp).float().repeat_interleave(rep, dim=2) \
        .reshape(bsz, nj, chunk, h, s)
    cc = _pad_seq(c, lp).float().repeat_interleave(rep, dim=2) \
        .reshape(bsz, nj, chunk, h, s)
    af = a.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((bsz, h, p, s), dtype=torch.float32,
                        device=x.device) if h0 is None else h0.float()
    ys = []
    for j in range(nj):
        xj, dj, bj, cj = xc[:, j], dtc[:, j], bc[:, j], cc[:, j]
        cum = torch.cumsum(dj * af[None, None, :], dim=1)     # (B, C, H)
        total = cum[:, -1]                                     # (B, H)
        gm = torch.einsum("bths,buhs->bhtu", cj, bj)           # (B,H,C,C)
        rel = (cum[:, :, None, :] - cum[:, None, :, :]).movedim(3, 1)
        rel = torch.where(tri, rel, 0.0)       # mask before exp
        lmat = torch.where(tri, torch.exp(rel)
                           * dj.movedim(2, 1)[:, :, None, :], 0.0)
        y_intra = torch.einsum("bhtu,buhp->bthp", gm * lmat, xj)
        y_inter = torch.einsum("bths,bhps->bthp",
                               cj * torch.exp(cum)[..., None], state)
        w = torch.exp(total[:, None] - cum) * dj               # (B, C, H)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "buhp,buhs->bhps", xj, bj * w[..., None])
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, lp, h, p)[:, :length]
    if d is not None:
        y = y + d.float()[None, None, :, None] * x.float()
    y = y.to(x.dtype)
    return (y, state) if return_final_state else y


def smem_bytes(chunk: int, p: int, s: int) -> int:
    """Shared memory of one kernel block (csrc/ssd_scan.cu ``smem_floats``):
    the x, B and C tiles, the state, a row block of the decay-score
    matrix and three per-position vectors, all fp32, rows padded by one."""
    return 4 * (chunk * p + 2 * chunk * (s + 1) + p * (s + 1)
                + ROW_BLOCK * (chunk + 1) + 3 * chunk)


def _check_inner(name: str, key: str, t: torch.Tensor) -> None:
    """The kernel reads (B, L, ...) tensors through their batch and
    sequence strides; the dims after L must be packed."""
    inner = 1
    for dim in range(t.ndim - 1, 1, -1):
        if t.shape[dim] > 1 and t.stride(dim) != inner:
            raise ValueError(f"{name}: {key} dims after L are not packed "
                             f"(strides {t.stride()})")
        inner *= t.shape[dim]


def ssd_scan(x, dt, a, b, c, d=None, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, S) with
    G dividing H; d: (H,) or None; h0: (B, H, P, S) or None (zeros).
    Returns y (B, L, H, P) in x's dtype, and with ``return_final_state``
    the final state (B, H, P, S) fp32.  On a CUDA tensor this launches
    the kernel (or raises); a CPU tensor takes the plain version.  x, b
    and c may be views into one wider tensor (the model's conv output):
    the kernel reads them through their batch and sequence strides."""
    check_no_grad("ssd_scan", {"x": x, "dt": dt, "a": a, "b": b, "c": c,
                               "d": d, "h0": h0})
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, d, chunk=chunk, h0=h0,
                              return_final_state=return_final_state)
    bsz, length, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if dt.shape != (bsz, length, h) or b.shape != (bsz, length, g, s) \
            or c.shape != b.shape or a.shape != (h,) or h % g \
            or (d is not None and d.shape != (h,)) \
            or (h0 is not None and h0.shape != (bsz, h, p, s)):
        raise ValueError(
            f"ssd_scan: shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
            f"a{tuple(a.shape)} b{tuple(b.shape)} c{tuple(c.shape)} "
            f"d{None if d is None else tuple(d.shape)} "
            f"h0{None if h0 is None else tuple(h0.shape)}")
    if p > MAX_HEAD_DIM or s > MAX_STATE or not 1 <= chunk <= MAX_CHUNK \
            or smem_bytes(chunk, p, s) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: P={p} S={s} chunk={chunk} outside the "
                         f"kernel's P<={MAX_HEAD_DIM}, S<={MAX_STATE}, "
                         f"chunk<={MAX_CHUNK}")
    tensors = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d, "h0": h0}
    for key, t in tensors.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"ssd_scan: {key} on {t.device}, expected "
                             f"{x.device}")
    if x.dtype not in build.DTYPE_CODES or b.dtype != x.dtype \
            or c.dtype != x.dtype or dt.dtype not in build.DTYPE_CODES:
        raise ValueError(
            f"ssd_scan: x, b, c must share fp32 or bf16 and dt be one of "
            f"them (x {x.dtype}, dt {dt.dtype}, b {b.dtype}, c {c.dtype})")
    for key in ("x", "dt", "b", "c"):
        _check_inner("ssd_scan", key, tensors[key])
    a = a.float().contiguous()
    d = None if d is None else d.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    y = torch.empty((bsz, length, h, p), dtype=x.dtype, device=x.device)
    hout = torch.empty((bsz, h, p, s), dtype=torch.float32, device=x.device)
    build.launch("ssd_scan", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 b.data_ptr(), c.data_ptr(),
                 0 if d is None else d.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hout.data_ptr(), bsz, length, h, p, g, s, chunk,
                 x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                 b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                 build.dtype_code(x), build.dtype_code(dt))
    return (y, hout) if return_final_state else y


def ssd_step(x_t, dt_t, a, b_t, c_t, d, h):
    """One-token SSD update for decode (``repro/kernels/xla_fallback.py``
    ``ssd_step``; plain PyTorch, as the JAX package's is plain lax):
    h' = exp(a dt) h + dt x (outer) b; y = c . h' + d x.
    x_t: (B, H, P); dt_t: (B, H); b_t, c_t: (B, G, S); h: (B, H, P, S).
    Returns (y (B, H, P) in x_t's dtype, h' fp32)."""
    rep = x_t.shape[1] // b_t.shape[1]
    bb = b_t.repeat_interleave(rep, dim=1).float()
    cc = c_t.repeat_interleave(rep, dim=1).float()
    xf, dtf = x_t.float(), dt_t.float()
    dec = torch.exp(a.float()[None] * dtf)                    # (B, H)
    h = h * dec[..., None, None] \
        + (xf * dtf[..., None])[..., None] * bb[:, :, None, :]
    y = torch.einsum("bhps,bhs->bhp", h, cc)
    if d is not None:
        y = y + d.float()[None, :, None] * xf
    return y.to(x_t.dtype), h
