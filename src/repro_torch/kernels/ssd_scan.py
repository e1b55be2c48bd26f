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

In bf16 the kernel runs its chunks in parallel on the tensor cores (the
notes of the ``.cu`` file): :func:`ssd_plan` is that body's work
partition and workspace layout, a function of the shapes and the SM
count alone, and :func:`ssd_scan_by_plan` its arithmetic in fp32 and in
its chunk-parallel form (the state-free part of every work item, then
the chain of states, then the outputs).  The workspace (a ticket, the
chain's flags and two state slots a chain) is kept per (device, stream),
grown to the largest plan it has served, and never cleared: the ticket
only counts up (each launch is told where it began) and each launch's
flags hold its own epoch, so a serve path's prefill chunks of many
lengths share one.  fp32 inputs, and bf16 shapes off the
tensor-core grid, run the first (FMA) body.

The kernel has no backward (nor has the TPU kernel), so the wrapper
raises ``NotImplementedError`` on an input that requires grad with
autograd on, on either device.  :func:`ssd_scan_plain` differentiates:
training reaches it through ``ops.ssd``'s grad-mode dispatch.  A CPU
or meta tensor takes the plain version; under an active cost counter
the wrapper, and the plain version where it stands in for the kernel
(no input tracked by autograd), report the kernel's closed form.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.fused_attention import _sm_count, on_plain_device

#: the kernel's limits (csrc/ssd_scan.cu kMaxP, kMaxS, kMaxChunk)
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 128
#: rows of the FMA body's decay-score matrix held in shared memory at once
ROW_BLOCK = 32
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
#: the bf16 body's geometry (csrc/ssd_scan.cu, namespace ssd): row
#: strides (bf16) of its C, B and h tiles and of its x tiles, and the P
#: slice widths it takes
TILE_STRIDE, X_STRIDE = 136, 72
SLICE_WIDTHS = (64, 32, 16)


def tracked(tensors: dict) -> list:
    """The names of the inputs autograd would track: with grad mode on,
    those that require grad."""
    if not torch.is_grad_enabled():
        return []
    return [k for k, t in tensors.items()
            if t is not None and t.requires_grad]


def check_no_grad(name: str, tensors: dict) -> None:
    """Refuse, on any device, an input that autograd would track."""
    names = tracked(tensors)
    if names:
        raise NotImplementedError(
            f"{name}: {names} require grad, but the SSD scan kernel has no "
            "backward (the JAX package's ssd_scan kernel has none); call "
            "it under torch.no_grad(), or ops.ssd with impl 'auto' or "
            "'torch', which differentiates through the plain version")


def _pad_seq(t: torch.Tensor, length: int) -> torch.Tensor:
    pad = length - t.shape[1]
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))],
                     dim=1)


def _ssd_cost_args(x, dt, a, b, c, d=None, *, chunk=128, h0=None,
                   return_final_state=False):
    """#11's cost arguments (``kernels/cost.py``)."""
    bsz, length, h, p = x.shape
    return (bsz, length, h, p, b.shape[2], b.shape[3], chunk), dict(
        el=x.element_size(), h0=h0 is not None, d=d is not None)


def _stands_in(x, dt, a, b, c, d=None, *, h0=None, **kw) -> bool:
    """Whether a plain call stands in for the kernel: no input tracked
    by autograd (training differentiates the plain scan itself, which
    no kernel replaces, and counts its ops)."""
    return not tracked({"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d,
                        "h0": h0})


@cost.counted("ssd_scan", _ssd_cost_args, when=_stands_in)
def ssd_scan_plain(x, dt, a, b, c, d=None, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None,
                   return_final_state: bool = False):
    """The plain version (``repro/kernels/xla_fallback.py``
    ``chunked_ssd``): the arrays zero-padded to a chunk multiple, the
    groups repeated over the heads, one chunk at a time.
    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, S).  On
    the meta device, where it stands in for the kernel (whose closed
    form a cost count takes), it returns its outputs' shapes without
    the loop over chunks: there is no data to scan."""
    bsz, length, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if x.device.type == "meta" and _stands_in(x, dt, a, b, c, d, h0=h0):
        y = torch.empty_like(x)
        state = torch.empty((bsz, h, p, s), dtype=torch.float32,
                            device=x.device)
        return (y, state) if return_final_state else y
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
    """Shared memory of one FMA block (csrc/ssd_scan.cu ``smem_floats``):
    the x, B and C tiles, the state, a row block of the decay-score
    matrix and three per-position vectors, all fp32, rows padded by one."""
    return 4 * (chunk * p + 2 * chunk * (s + 1) + p * (s + 1)
                + ROW_BLOCK * (chunk + 1) + 3 * chunk)


class SsdPlan(NamedTuple):
    """The bf16 body's partition of one shape: ``n_items`` work items
    (chunk, row, group, tile of ``ht`` heads, slice of ``pw`` P columns),
    chunk-major in ticket order (:func:`ssd_items`); ``nht`` head tiles a
    group (the last may be short), ``nps`` slices; each item computes
    C B^T once for its heads.  ``n_chains`` (row, head, slice) states
    pass from chunk to chunk through the workspace: the ticket at 0, the
    flags (chain, chunk) at ``flags_at``, two fp32 (pw, S) slots a chain
    at ``slots_at``."""
    nj: int
    ht: int
    nht: int
    pw: int
    nps: int
    n_items: int
    n_chains: int
    smem_bytes: int
    flags_at: int
    slots_at: int
    workspace_bytes: int


def _up256(n: int) -> int:
    return -(-n // 256) * 256


def mma_smem_bytes(chunk: int, pw: int, ht: int) -> int:
    """Shared memory of one bf16 block (csrc/ssd_scan.cu
    ``ssd::smem_bytes``): C, B, two x tiles and h as a bf16 pair, C B^T
    in fp32, dt of the item's heads, cum, w and the scores' column
    factors of two heads."""
    return 2 * (2 * chunk * TILE_STRIDE + 2 * chunk * X_STRIDE
                + 2 * pw * TILE_STRIDE) \
        + 4 * (chunk * (chunk + 8) + ht * chunk + 6 * chunk) + 16


def ssd_plan(b: int, length: int, h: int, p: int, g: int, s: int,
             chunk: int, n_sm: int) -> Optional[SsdPlan]:
    """The bf16 body's partition, or None where the shape is off its grid
    (chunk, S or P not a multiple of 16: the FMA body takes it).  Of the
    slice widths and head tiles that fit shared memory it takes the one
    with the least estimated time, waves of ``n_sm`` items times an
    item's multiply-adds (C B^T's causal half once, then per head the
    scores' product, C h and the state's); ties go to fewer items (fewer
    C B^T recomputed), then wider slices."""
    if chunk % 16 or s % 16 or p % 16:
        return None
    nj, rep = -(-length // chunk), h // g
    cb = chunk * chunk * s // 2
    best = None
    for pw in SLICE_WIDTHS:
        if p % pw:
            continue
        head = chunk * chunk * pw // 2 + 2 * chunk * pw * s
        for nht in range(1, rep + 1):
            ht = -(-rep // nht)
            if -(-rep // ht) != nht \
                    or mma_smem_bytes(chunk, pw, ht) > SMEM_LIMIT:
                continue
            items = b * nj * g * nht * (p // pw)
            key = (-(-items // n_sm) * (cb + ht * head), items, -pw)
            if best is None or key < best[0]:
                best = (key, pw, ht, nht, items)
    _, pw, ht, nht, items = best
    nps = p // pw
    chains = b * h * nps
    flags_at = 256
    slots_at = _up256(flags_at + 8 * chains * nj)
    return SsdPlan(nj, ht, nht, pw, nps, items, chains,
                   mma_smem_bytes(chunk, pw, ht), flags_at, slots_at,
                   slots_at + 8 * chains * pw * s)


def ssd_items(plan: SsdPlan, b: int, h: int, g: int) -> Iterator[tuple]:
    """The work items in ticket order, as the kernel decodes its ticket:
    (chunk, row, group, first head, heads, first P column)."""
    rep = h // g
    for item in range(plan.n_items):
        ps, rest = item % plan.nps, item // plan.nps
        tile, rest = rest % plan.nht, rest // plan.nht
        gi, rest = rest % g, rest // g
        bi, j = rest % b, rest // b
        h_lo = gi * rep + tile * plan.ht
        yield j, bi, gi, h_lo, min(plan.ht, (gi + 1) * rep - h_lo), \
            ps * plan.pw


def ssd_scan_by_plan(x, dt, a, b, c, d=None, *, chunk: int = 128,
                     h0: Optional[torch.Tensor] = None, n_sm: int = 132):
    """The bf16 body's arithmetic in fp32, in its chunk-parallel form:
    every item of :func:`ssd_plan` does its state-free part (the cumsum,
    C B^T once for its heads, the masked scores, y's intra-chunk part,
    the chunk's own state X^T (B o w)); then the chain passes each
    (row, head, slice) state along the chunks; then each item adds
    exp(cum) C h_{j-1}^T and d x.  Returns (y fp32, final state)."""
    bsz, length, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    plan = ssd_plan(bsz, length, h, p, g, s, chunk, n_sm)
    f32 = dict(dtype=torch.float32, device=x.device)
    x, dt, b, c, a = x.float(), dt.float(), b.float(), c.float(), a.float()
    y = torch.zeros((bsz, length, h, p), **f32)
    own = torch.zeros((plan.nj, bsz, h, p, s), **f32)
    decay = torch.zeros((plan.nj, bsz, h), **f32)
    cums = {}
    for j, bi, gi, h_lo, nh, p0 in ssd_items(plan, bsz, h, g):
        rows, cols = slice(j * chunk, (j + 1) * chunk), \
            slice(p0, p0 + plan.pw)
        cm, bm = c[bi, rows, gi], b[bi, rows, gi]
        n = cm.shape[0]
        cb = cm @ bm.T                                  # once per item
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=x.device))
        for hh in range(h_lo, h_lo + nh):
            dtv = dt[bi, rows, hh]
            cum = torch.cumsum(dtv * a[hh], 0)
            rel = torch.where(tri, cum[:, None] - cum[None, :], 0.0)
            scores = torch.where(tri, cb * torch.exp(rel) * dtv[None], 0.0)
            xs = x[bi, rows, hh, cols]
            y[bi, rows, hh, cols] = scores @ xs
            w = torch.exp(cum[-1] - cum) * dtv
            own[j, bi, hh, cols] = xs.T @ (bm * w[:, None])
            decay[j, bi, hh] = torch.exp(cum[-1])
            cums[j, bi, hh] = cum
    state = torch.zeros((bsz, h, p, s), **f32) if h0 is None \
        else h0.float().clone()
    prev = []
    for j in range(plan.nj):                            # the chain
        prev.append(state)
        state = decay[j][..., None, None] * state + own[j]
    for j, bi, gi, h_lo, nh, p0 in ssd_items(plan, bsz, h, g):
        rows, cols = slice(j * chunk, (j + 1) * chunk), \
            slice(p0, p0 + plan.pw)
        for hh in range(h_lo, h_lo + nh):
            y[bi, rows, hh, cols] += torch.exp(cums[j, bi, hh])[:, None] \
                * (c[bi, rows, gi] @ prev[j][bi, hh, cols].T)
    if d is not None:
        y = y + d.float()[None, None, :, None] * x
    return y, state


#: (device, stream) -> [workspace, the epoch of its last launch, the
#: tickets its launches have drawn]
_WORKSPACES: dict = {}

#: stamps of a traced bf16 launch, per item: its start, then per head of
#: its tile the head's start, its own state done, the incoming state
#: received, its state published, its y done
STAMPS_PER_HEAD = 5
#: None, or a contiguous int64 CUDA tensor of (n_items, 1 + 5 ht) of the
#: launch's plan: while it is set, each bf16 launch writes every item's
#: globaltimer (ns) at each stamp into it (time_ssd_scan.py reads it)
PHASE_TRACE: Optional[torch.Tensor] = None


def _trace_ptr(x, plan: SsdPlan) -> Optional[int]:
    t = PHASE_TRACE
    if t is None:
        return None
    shape = (plan.n_items, 1 + STAMPS_PER_HEAD * plan.ht)
    if t.dtype != torch.int64 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != x.device:
        raise ValueError(f"PHASE_TRACE must be a contiguous int64 {shape} "
                         f"tensor on {x.device}")
    return t.data_ptr()


def _workspace(x, plan: SsdPlan) -> tuple:
    """(workspace, epoch, ticket base) of a launch: the current stream's
    workspace, zeroed when made and made anew (larger) when the plan
    needs more; this launch's epoch on it (its flags' value; it keeps
    counting across a regrowth, so no flag ever holds a later one); the
    ticket's value before this launch draws its n_items.  Launches on one
    stream run in order, so they share it; two streams never do."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    entry = _WORKSPACES.get(key)
    if entry is None or entry[0].numel() < plan.workspace_bytes:
        epoch = 0 if entry is None else entry[1]
        entry = [torch.zeros(plan.workspace_bytes, dtype=torch.uint8,
                             device=x.device), epoch, 0]
        _WORKSPACES[key] = entry
    entry[1] += 1
    base = entry[2]
    entry[2] += plan.n_items
    return entry[0], entry[1], base


def _check_inner(name: str, key: str, t: torch.Tensor) -> None:
    """The kernel reads (B, L, ...) tensors through their batch and
    sequence strides; the dims after L must be packed."""
    inner = 1
    for dim in range(t.ndim - 1, 1, -1):
        if t.shape[dim] > 1 and t.stride(dim) != inner:
            raise ValueError(f"{name}: {key} dims after L are not packed "
                             f"(strides {t.stride()})")
        inner *= t.shape[dim]


@cost.counted("ssd_scan", _ssd_cost_args)
def ssd_scan(x, dt, a, b, c, d=None, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, S) with
    G dividing H; d: (H,) or None; h0: (B, H, P, S) or None (zeros).
    Returns y (B, L, H, P) in x's dtype, and with ``return_final_state``
    the final state (B, H, P, S) fp32.  On a CUDA tensor this launches
    the kernel (or raises); a CPU or meta tensor takes the plain
    version.  x, b and c may be views into one wider tensor (the model's
    conv output): the kernel reads them through their batch and sequence
    strides."""
    check_no_grad("ssd_scan", {"x": x, "dt": dt, "a": a, "b": b, "c": c,
                               "d": d, "h0": h0})
    if on_plain_device(x):
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
    plan = None if x.dtype != torch.bfloat16 else ssd_plan(
        bsz, length, h, p, g, s, chunk, _sm_count(x.device.index))
    ws, epoch, base = (None, 0, 0) if plan is None else _workspace(x, plan)
    build.launch("ssd_scan", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 b.data_ptr(), c.data_ptr(),
                 0 if d is None else d.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hout.data_ptr(), bsz, length, h, p, g, s, chunk,
                 x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                 b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                 build.dtype_code(x), build.dtype_code(dt),
                 0 if ws is None else ws.data_ptr(),
                 0 if ws is None else ws.numel(), epoch, base,
                 0 if plan is None else plan.ht,
                 0 if plan is None else plan.nps,
                 None if plan is None else _trace_ptr(x, plan))
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
