"""The work partition of the SSD scan's bf16 body (#11,
``ssd_scan.ssd_plan``, the mirror of ``csrc/ssd_scan.cu``'s ticket
decode) and that partition's arithmetic, on the CPU: every (row, chunk,
head, P column) is covered by exactly one work item; C B^T is computed
once per item for all of its heads, so at mamba2-130m's cache-free shape
twice per (row, group, chunk) and not once per head; items are drawn in
chunk order, so the item that publishes a chain's state for chunk j-1
always precedes the one that waits on it; and the plan's arithmetic in
fp32, in its chunk-parallel form (``ssd_scan_by_plan``: the state-free
part of every item, then the chain, then the outputs), equals the Pallas
``ssd_scan`` in interpret mode and ``chunked_ssd`` with an initial state
on the same numpy inputs at 1e-5: both compute the same formulas in
fp32, summing in other orders."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import xla_fallback as jxla

from repro_torch.kernels import ssd_scan as sk

torch.set_num_threads(2)

CSRC = Path(sk.__file__).resolve().parent / "csrc" / "ssd_scan.cu"
TOL = dict(rtol=1e-5, atol=1e-5)
N_SM = 132

#: B, L, H, P, G, S, chunk: mamba2-130m's cache-free forward, the serve
#: path's prefill chunks (off and on the chunk grid), then small shapes
#: off the grid, with G = 2 and 4 and head tiles that do not divide H/G
SHAPES = [
    (4, 2048, 24, 64, 1, 128, 128),
    (1, 188, 24, 64, 1, 128, 128),
    (1, 256, 24, 64, 1, 128, 128),
    (1, 2048, 9, 64, 1, 128, 128),
    (2, 300, 16, 64, 2, 128, 64),
    (2, 300, 20, 64, 4, 128, 64),
    (2, 75, 8, 32, 4, 64, 32),
    (1, 128, 2, 64, 1, 32, 128),
]


def _inputs(B, L, H, P, G, S, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, L, H, P)).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, H)))) * 0.1).astype(f)
    a = (-np.exp(rng.standard_normal(H))).astype(f)
    b = (rng.standard_normal((B, L, G, S)) * 0.3).astype(f)
    c = (rng.standard_normal((B, L, G, S)) * 0.3).astype(f)
    d = rng.standard_normal(H).astype(f)
    h0 = (rng.standard_normal((B, H, P, S)) * 0.5).astype(f)
    return x, dt, a, b, c, d, h0


@pytest.mark.parametrize("n_sm", [N_SM, 16])
@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SHAPES)
def test_items_cover_every_row_chunk_head_column_once(B, L, H, P, G, S,
                                                      chunk, n_sm):
    plan = sk.ssd_plan(B, L, H, P, G, S, chunk, n_sm)
    rep = H // G
    seen = np.zeros((B, plan.nj, H, P), dtype=np.int64)
    last_j = 0
    for j, bi, gi, h_lo, nh, p0 in sk.ssd_items(plan, B, H, G):
        assert j >= last_j                      # chunk-major tickets
        last_j = j
        assert 1 <= nh <= plan.ht
        assert gi * rep <= h_lo and h_lo + nh <= (gi + 1) * rep
        seen[bi, j, h_lo:h_lo + nh, p0:p0 + plan.pw] += 1
    assert (seen == 1).all()
    assert plan.n_items == B * plan.nj * G * plan.nht * plan.nps
    assert plan.n_chains == B * H * plan.nps and plan.pw * plan.nps == P
    assert plan.pw in sk.SLICE_WIDTHS
    assert plan.smem_bytes == sk.mma_smem_bytes(chunk, plan.pw, plan.ht) \
        <= sk.SMEM_LIMIT


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SHAPES)
def test_a_chain_publishes_before_it_is_awaited(B, L, H, P, G, S, chunk):
    """The item that publishes (row, head, slice)'s state for chunk j-1
    has a smaller ticket than the one of chunk j that waits on it, so a
    waiting block's producer has always started."""
    plan = sk.ssd_plan(B, L, H, P, G, S, chunk, N_SM)
    ticket = {}
    for t, (j, bi, gi, h_lo, nh, p0) in enumerate(
            sk.ssd_items(plan, B, H, G)):
        for hh in range(h_lo, h_lo + nh):
            ticket[j, bi, hh, p0] = t
    for (j, bi, hh, p0), t in ticket.items():
        if j:
            assert ticket[j - 1, bi, hh, p0] < t


def test_c_bt_once_per_item_for_all_its_heads():
    """C B^T is one product per item (``ssd_scan_by_plan`` and the
    kernel compute it before the head loop), for ht heads: at
    mamba2-130m's cache-free shape that is twice per (row, group, chunk)
    (two tiles of 12 heads on one wave of 128 items), not 24 times; on a
    card of 16 SMs once per (row, group, chunk); at the serve path's
    prefill chunk the 24 heads go to 48 slices of one head, 96 items
    in one wave on 132 SMs."""
    calls = []
    orig = torch.Tensor.__matmul__

    def counting(self, other):
        calls.append(tuple(self.shape) + tuple(other.shape))
        return orig(self, other)

    B, L, H, P, G, S, chunk = 2, 300, 16, 64, 2, 128, 64
    plan = sk.ssd_plan(B, L, H, P, G, S, chunk, N_SM)
    args = [torch.from_numpy(v) for v in _inputs(B, L, H, P, G, S)[:6]]
    torch.Tensor.__matmul__ = counting
    try:
        sk.ssd_scan_by_plan(*args, chunk=chunk)
    finally:
        torch.Tensor.__matmul__ = orig
    # C B^T: (n, S) @ (S, n); the rest have a P-slice side
    cbt = [s for s in calls if s[1] == S and s[2] == S and s[0] == s[3]]
    assert len(cbt) == plan.n_items

    free = sk.ssd_plan(4, 2048, 24, 64, 1, 128, 128, N_SM)
    assert (free.ht, free.nht, free.nps, free.n_items) == (12, 2, 1, 128)
    small = sk.ssd_plan(4, 2048, 24, 64, 1, 128, 128, 16)
    assert small.nht * small.nps == 1
    serve = sk.ssd_plan(1, 188, 24, 64, 1, 128, 128, N_SM)
    assert (serve.ht, serve.nps, serve.n_items) == (1, 2, 96)
    assert N_SM // 2 <= serve.n_items <= N_SM


def test_card_test_shapes_have_ragged_head_tiles():
    """tests/test_torch_cuda.py's cases with H/G not a multiple of the
    head tile are such on a card of 132 SMs."""
    for B, L, H, P, G, S, chunk in SHAPES[3:6]:
        plan = sk.ssd_plan(B, L, H, P, G, S, chunk, N_SM)
        assert (H // G) % plan.ht


def test_plan_is_none_off_the_tensor_core_grid():
    assert sk.ssd_plan(1, 100, 4, 64, 1, 128, 100, N_SM) is None
    assert sk.ssd_plan(1, 100, 4, 40, 1, 128, 64, N_SM) is None
    assert sk.ssd_plan(1, 100, 4, 64, 1, 72, 64, N_SM) is None


def test_plan_mirrors_the_kernel_source():
    """The strides and the workspace layout the plan assumes are the
    kernel's."""
    text = CSRC.read_text()
    assert f"constexpr int kSS = {sk.TILE_STRIDE};" in text
    assert f"constexpr int kXS = {sk.X_STRIDE};" in text
    assert "const long long flags_at = 256;" in text
    assert re.search(r"slots_at \+ chains \* 2 \* pw \* \(long long\)S \* 4",
                     text)
    plan = sk.ssd_plan(4, 2048, 24, 64, 1, 128, 128, N_SM)
    assert plan.flags_at == 256 and plan.slots_at % 256 == 0
    assert "slots_at = up(flags_at + chains * s.nj * 8);" in text
    assert plan.slots_at >= plan.flags_at + 8 * plan.n_chains * plan.nj
    assert plan.workspace_bytes == plan.slots_at \
        + 2 * plan.n_chains * plan.pw * 128 * 4


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SHAPES[1:])
def test_plan_arithmetic_matches_pallas_and_chunked_ssd(B, L, H, P, G, S,
                                                        chunk):
    """y and the final state of the chunk-parallel form against the TPU
    kernel in interpret mode (through the JAX ops.ssd, which pads an
    off-grid L; no h0) and against chunked_ssd with h0."""
    x, dt, a, b, c, d, h0 = _inputs(B, L, H, P, G, S, seed=L)
    j = list(map(jnp.asarray, (x, dt, a, b, c, d)))
    args = [torch.from_numpy(v) for v in (x, dt, a, b, c, d)]
    wy, wh = jops.ssd(*j, chunk=chunk, impl="pallas", interpret=True,
                      return_final_state=True)
    y, h = sk.ssd_scan_by_plan(*args, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)
    wy, wh = jxla.chunked_ssd(*j, chunk=chunk, h0=jnp.asarray(h0),
                              return_final_state=True)
    y, h = sk.ssd_scan_by_plan(*args, chunk=chunk, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_cache_free_shape_matches_chunked_ssd():
    """mamba2-130m's cache-free widths (16 chunks, 24 heads of one
    group), one row, against chunked_ssd with h0."""
    x, dt, a, b, c, d, h0 = _inputs(1, 2048, 24, 64, 1, 128, seed=7)
    j = list(map(jnp.asarray, (x, dt, a, b, c, d)))
    wy, wh = jxla.chunked_ssd(*j, chunk=128, h0=jnp.asarray(h0),
                              return_final_state=True)
    y, h = sk.ssd_scan_by_plan(*[torch.from_numpy(v)
                                 for v in (x, dt, a, b, c, d)],
                               chunk=128, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)
