"""The work partition of the decode megakernels' bf16 body (#3 and #6),
on the CPU.

``kernels/fused_decode_block.py`` ``decode_plan`` mirrors the partition
that ``csrc/fused_decode_block.cu`` computes from the shapes and the SM
count: Wq in units of 64 rows by one head, Wo in units of 64 rows by
128 columns, each dealt to the blocks in contiguous runs; attention
items (batch row, KV head, 16-row tile, key chunk) whose chunks cut a
row's 64-key tiles.  Here it covers every (head, E-slice), every (row,
KV head, key tile) and every (Wo row slice, column tile) exactly once,
no slot index reaches past its bound, and the runs differ by at most
one unit.  Then the body's arithmetic, driven by that plan in fp32 (the
slots summed in order, each chunk's online softmax over 64-key tiles,
the chunks merged in order, the output tiles summed in slot order),
against the Pallas ``fused_decode_block`` in interpret mode on the same
numpy inputs, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fused_decode_block import (
    fused_decode_block as pallas_decode_block)

from repro_torch.kernels import fused_decode_block as fdb

torch.set_num_threads(2)

# (b, hq, hkv, e, d, dv, n_blocks): starcoder2-7b's widths on 132 SMs
# at B = 1, 4 and 33; GQA groups 1, 5, 12 and 20 (two row tiles); runs
# shorter than a head's units, and more blocks than units
PLAN_SHAPES = [
    (4, 36, 4, 4608, 128, 128, 132), (1, 36, 4, 4608, 128, 128, 132),
    (33, 18, 2, 512, 128, 128, 132), (9, 45, 9, 4608, 128, 128, 132),
    (17, 12, 1, 200, 64, 64, 132), (3, 10, 2, 256, 40, 40, 7),
    (2, 40, 2, 96, 36, 36, 1000), (4, 36, 4, 4608, 128, 64, 114)]
LENGTHS = [0, 1, 63, 64, 65, 128, 705, 1024]


def _runs(units, n_blocks):
    return [fdb.unit_range(blk, units, n_blocks) for blk in range(n_blocks)]


def _check_weight_partition(units, per_tile, n_tiles, n_blocks, n_slots):
    runs = _runs(units, n_blocks)
    assert units == per_tile * n_tiles
    seen = np.zeros(units, dtype=int)
    for blk, (lo, hi) in enumerate(runs):
        seen[lo:hi] += 1
        for u in range(lo, hi):
            assert fdb.owner(u, units, n_blocks) == blk
            tile = u // per_tile
            j = blk - fdb.owner(tile * per_tile, units, n_blocks)
            assert 0 <= j < n_slots
    assert (seen == 1).all()
    lengths = [hi - lo for lo, hi in runs]
    assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("b,hq,hkv,e,d,dv,n_blocks", PLAN_SHAPES)
def test_weight_units_are_dealt_once_in_even_runs(b, hq, hkv, e, d, dv,
                                                  n_blocks):
    p = fdb.decode_plan(b, hq, hkv, e, d, dv, n_blocks)
    # Wq: hq heads of ceil(E / 64) slices; Wo: ceil(E / 128) column
    # tiles of ceil(hq * dv / 64) slices
    assert p.per_a == -(-e // 64) and p.units_a == hq * p.per_a
    _check_weight_partition(p.units_a, p.per_a, hq, n_blocks, p.slots_a)
    assert p.tiles_c == -(-e // 128) and p.per_c == -(-(hq * dv) // 64)
    _check_weight_partition(p.units_c, p.per_c, p.tiles_c, n_blocks,
                            p.slots_c)


def _items(p, b, hkv, lengths):
    """(row, kvh, row tile, chunk, first tile, end tile) of every
    attention item, as the kernel's item_of makes them."""
    out = []
    for i in range(b * hkv * p.n_rt * p.n_chunks):
        c, bkr = i % p.n_chunks, i // p.n_chunks
        rt, bk = bkr % p.n_rt, bkr // p.n_rt
        row, kvh = bk // hkv, bk % hkv
        nt = -(-lengths[row] // fdb.KEY_TILE)
        tpc = -(-nt // p.n_chunks)
        out.append((row, kvh, rt, c, c * tpc, min(nt, c * tpc + tpc)))
    return out


@pytest.mark.parametrize("b,hq,hkv,e,d,dv,n_blocks", PLAN_SHAPES)
def test_attention_items_cover_each_key_tile_once(b, hq, hkv, e, d, dv,
                                                  n_blocks):
    p = fdb.decode_plan(b, hq, hkv, e, d, dv, n_blocks)
    assert p.n_rt == -(-(hq // hkv) // fdb.ROW_TILE)
    assert p.n_chunks >= 1
    assert b * hkv * p.n_rt * p.n_chunks <= max(n_blocks,
                                                b * hkv * p.n_rt)
    lengths = [LENGTHS[i % len(LENGTHS)] for i in range(b)]
    seen = {}
    for row, kvh, rt, c, t0, t1 in _items(p, b, hkv, lengths):
        for t in range(t0, t1):
            key = (row, kvh, rt, t)
            seen[key] = seen.get(key, 0) + 1
    want = {(row, kvh, rt, t) for row in range(b) for kvh in range(hkv)
            for rt in range(p.n_rt)
            for t in range(-(-lengths[row] // fdb.KEY_TILE))}
    assert set(seen) == want and set(seen.values()) <= {1}


def _rope(q, pos, theta):
    """RoPE of the (.., D) rows q at ``pos``, pairs (i, i + D/2), as the
    kernel rotates them."""
    half = q.shape[-1] // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * (-np.log(theta) / half))
    ang = pos * freq
    cs, sn = torch.cos(ang), torch.sin(ang)
    lo, hi = q[..., :half], q[..., half:]
    return torch.cat([lo * cs - hi * sn, hi * cs + lo * sn], -1)


def _planned_decode(x, wq, k, v, wo, res, lengths, theta, n_blocks):
    """The bf16 body's arithmetic in fp32, driven by decode_plan: phase
    (a)'s runs into slots summed in order; phase (b)'s chunks of 64-key
    tiles with the online softmax, merged in chunk order; phase (c)'s
    runs into slots summed in order, then the residual."""
    b, _, e = x.shape
    hq, d = wq.shape[1:]
    hkv, dv = k.shape[1], v.shape[3]
    p = fdb.decode_plan(b, hq, hkv, e, d, dv, n_blocks)
    x2, w2 = x[:, 0], wq.reshape(e, hq * d)
    runs_a = _runs(p.units_a, n_blocks)

    def slotted(runs, per, n_tiles, cols, rows_in, w):
        """Each block's partial of each tile its run covers, summed per
        tile in slot order."""
        parts = {}
        for lo, hi in runs:
            for u in range(lo, hi):
                t, s = divmod(u, per)
                r0, r1 = s * 64, min((s + 1) * 64, w.shape[0])
                c0, c1 = cols(t)
                part = rows_in[:, r0:r1] @ w[r0:r1, c0:c1]
                parts.setdefault(t, []).append((lo, part))
        out = []
        for t in range(n_tiles):
            acc = torch.zeros_like(parts[t][0][1])
            for _, part in sorted(parts[t], key=lambda q: q[0]):
                acc = acc + part
            out.append(acc)
        return torch.cat(out, 1)

    q = slotted(runs_a, p.per_a, hq, lambda t: (t * d, (t + 1) * d), x2, w2)
    q = q.view(b, hq, d)
    pos = (lengths.clamp(0, k.shape[2]) - 1).float()[:, None, None]
    q = _rope(q, pos, theta)
    group = hq // hkv
    o = torch.zeros(b, hq, dv)
    for row in range(b):
        n = int(lengths[row].clamp(0, k.shape[2]))
        nt = -(-n // 64)
        tpc = -(-nt // p.n_chunks)
        for h in range(hq):
            kk, vv = k[row, h // group], v[row, h // group]
            chunks = []
            for c in range(p.n_chunks):
                t0, t1 = c * tpc, min(nt, c * tpc + tpc)
                if t0 >= t1:
                    continue
                m, l, acc = torch.tensor(-1e30), torch.tensor(0.), \
                    torch.zeros(dv)
                for t in range(t0, t1):
                    j0, j1 = t * 64, min(n, t * 64 + 64)
                    s = kk[j0:j1] @ q[row, h] * d ** -0.5
                    m_new = torch.maximum(m, s.max())
                    alpha = torch.exp(m - m_new)
                    pr = torch.exp(s - m_new)
                    l = l * alpha + pr.sum()
                    acc = acc * alpha + pr @ vv[j0:j1]
                    m = m_new
                chunks.append((m, l, acc))
            if chunks:
                mx = max(c[0] for c in chunks)
                w = [torch.exp(c[0] - mx) for c in chunks]
                lsum = sum(c[1] * wi for c, wi in zip(chunks, w))
                oo = sum(c[2] * wi for c, wi in zip(chunks, w))
                o[row, h] = oo / (lsum if lsum != 0 else 1.0)
    y = slotted(_runs(p.units_c, n_blocks), p.per_c, p.tiles_c,
                lambda t: (t * 128, min(e, (t + 1) * 128)), o.reshape(b, -1),
                wo.reshape(hq * dv, e))
    return (res[:, 0] + y)[:, None]


@pytest.mark.parametrize("b,hq,hkv,e,d,n_blocks,lengths", [
    (3, 6, 2, 200, 16, 11, [0, 77, 200]),
    (2, 10, 2, 96, 8, 132, [130, 1]),
    (5, 4, 4, 130, 8, 3, [64, 65, 0, 128, 129])])
def test_planned_arithmetic_matches_pallas(b, hq, hkv, e, d, n_blocks,
                                           lengths):
    rng = np.random.default_rng(0)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    skv = 256
    x, res = r(b, 1, e), r(b, 1, e)
    wq, wo = r(e, hq, d, scale=e ** -0.5), r(hq, d, e, scale=(hq * d) ** -0.5)
    k, v = r(b, hkv, skv, d), r(b, hkv, skv, d)
    lens = np.array(lengths, dtype=np.int32)
    want = pallas_decode_block(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(wo), jnp.asarray(res), jnp.asarray(lens),
        rope_theta=1e4, interpret=True)
    got = _planned_decode(*(torch.from_numpy(a) for a in
                            (x, wq, k, v, wo, res, lens)), 1e4, n_blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
