"""The port's CUDA kernels on the card (marker ``cuda``; every test
skips without a CUDA device).  This file imports no JAX, so it runs on
a machine with the card and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel against its plain PyTorch version on the same inputs, in
fp32 (atol/rtol 1e-4: fp32 FMAs in another order) and bf16 (2e-2: both
round p, Q and the output to bf16, unit roundoff 2^-8), over a GQA
group of 3, a length of 0, a ragged length and Sq > 1; the decode
megakernel's head sum is deterministic; launches are counted.  The
decode megakernels' bf16 body (#3, #6) holds per row against its plain
version at B = 1, 4, 9, 17 and 33, GQA groups 1, 5, 9 and 12, E on and
off its tiles and D = 128, 64, 40 and 36, over lengths 0, 1, page and
key-chunk edges and the whole cache; it is bitwise repeatable, a
length-0 row returns its residual, #6 equals #3 bit for bit over pages
of 8 and 16, fp32 stays on the FMA body at 1e-4, the workspace is kept
and its tickets left at zero, and a traced launch stamps its phases in
order across both grid barriers.  Each paged kernel, over a shuffled
table of a pool larger than the batch needs (pages of 8, 40 and 128, a
dead row whose table row is zeros),
matches its plain version and gives bit for bit its dense kernel's
output on the gathered cache: the two share one body.  #4 at qwen3-8b's
widths and M=1 (B=2 and 4; pages of 8, 16 and 128; lengths 0, 1, a page
edge, and one that takes more blocks than the card has SMs) runs the
split-KV body, equal to #1 and to itself bit for bit.  At one-pass
shapes #1 and #2 run the tensor-core body in bf16 and the FMA body in
fp32 (D = 128, 64 and 40; lengths 0, 1, 63, 64, 65 and the full cache;
Sq off the 64-row grid, so a block's rows span two query heads), are
bitwise repeatable, and #4 and #5 equal them bit for bit over pages of
8, 16 and 128, #5 at M=1 too.  The training
kernels (forward with lse, dq, dk/dv, the Q-projection forward) match
their plain versions relative to each output's largest magnitude (fp32
1e-4, bf16 2e-2) off the tile grids and at the edges of the 64-row and
64-key tiles of the tensor-core bodies of #7, #8 and #9, with GQA, an
explicit causal offset (a negative one too), Sq > Skv, D = 40 and 36
and Dv != D; rows that see no key emit o = 0 and lse = -1e30 and keys
no row sees get no gradient; dq, dk/dv and #10 are bitwise repeatable;
#10 holds at D = 128, 40 and 36 (x, Wq, K and V by plain loads); every
instantiation of the bf16 tensor-core bodies shows HMMA in its SASS;
backward through a one-layer model on the kernels reaches wq, wk and
wv; the serve kernels refuse a tensor that requires grad.  The
Mamba-2 SSD scan (#11) matches its plain version in fp32 and
bf16, with and without an initial state, on and off the chunk grid, at
one and several groups, over 1, 2 and 16 chunks and head tiles that do
not divide H/G; its bf16 tensor-core body holds per row (also with a
long memory, dt scaled by 0.05), is bitwise repeatable (a zero h0 gives
what no h0 gives), keeps one workspace a stream, grown as needed, stamps
its phases in order when traced; it
reads strided views, aligned or not, bit for bit as their copies; and a
2-layer full-width mamba2-130m forward on it matches the plain versions.
qwen3-14b and starcoder2-15b (GQA groups 5 and 12) serve one layer at
full width on the kernels their DSE-lowered plans pick, against the
plain versions.  The modality frontends: #1, #2 and #7-#9 at
hubert-xlarge's heads (16 of 80, non-causal, lengths off the tiles);
hubert at full width, 2 layers, trains on the kernels under each remat
policy (#7 recomputed under "full" and "dots") against the plain
versions; internvl2-2b serves 256 patch rows before its text on #1 and
#3 against the plain versions.  phi3.5-moe at full width, one layer:
its gradients (B = 4, S = 256, bf16) bitwise repeatable, a zero router
routing every token to experts 0 and 1 on the card (JAX's tie order),
and its MoE FFN in fp32 compute within 1e-4 of the CPU's.  MLA training:
#7-#9 at D 192 / Dv 128 (the ``*_mma_kernel_d192`` instantiations in
bf16, the FMA bodies sized for 192 in fp32) and at D 160 / Dv 96 and D
130 / Dv 66, per row against their plain versions, bitwise repeatable,
that gate shown to reject a dropped key tile and a dropped query tile;
D 200 or Dv 136 refused by the wrappers and the C entry points; two
MLA layers at those head widths train on the kernels against the plain
versions.  Each of the eleven wrappers on CUDA tensors launches its
kernel with its plain version made to raise, and reports its closed-form
cost (``kernels/cost.py``) to an active cost counter.
"""

import functools

import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_attention import (
    causal_anchor, chunk_bounds, fused_attention, fused_attention_bwd_dkv,
    fused_attention_bwd_dkv_plain, fused_attention_bwd_dq,
    fused_attention_bwd_dq_plain, fused_attention_fwd,
    fused_attention_fwd_plain, fused_attention_masked,
    fused_attention_masked_plain, fused_attention_paged,
    fused_attention_paged_plain, split_chunks)
from repro_torch.kernels.fused_decode_block import (
    fused_decode_block, fused_decode_block_paged,
    fused_decode_block_paged_plain, fused_decode_block_plain)
from repro_torch.kernels.fused_qproj_attention import (
    fused_qproj_attention, fused_qproj_attention_fwd,
    fused_qproj_attention_fwd_plain, fused_qproj_attention_masked,
    fused_qproj_attention_masked_plain, fused_qproj_attention_paged,
    fused_qproj_attention_paged_plain)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    b, hq, hkv, skv, e, d = 3, 9, 3, 200, 96, 64
    return dict(
        lens=torch.tensor([0, 77, 200], dtype=torch.int32, device=dev),
        q=r(b, hq, 5, d), k=r(b, hkv, skv, d), v=r(b, hkv, skv, d),
        x=r(b, 5, e), wq=r(e, hq, d, scale=e ** -0.5), x1=r(b, 1, e),
        res=r(b, 1, e), wo=r(hq, d, e, scale=(hq * d) ** -0.5))


TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_fused_attention_masked_matches_plain(cuda_device, dtype, tol):
    t = _inputs(cuda_device, dtype)
    for causal in (True, False):
        got = fused_attention_masked(t["q"], t["k"], t["v"], t["lens"],
                                     causal=causal)
        want = fused_attention_masked_plain(t["q"], t["k"], t["v"],
                                            t["lens"], causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_fused_qproj_attention_masked_matches_plain(cuda_device, dtype,
                                                    tol):
    t = _inputs(cuda_device, dtype)
    for theta in (1e4, None):
        got = fused_qproj_attention_masked(t["x"], t["wq"], t["k"], t["v"],
                                           t["lens"], rope_theta=theta)
        want = fused_qproj_attention_masked_plain(
            t["x"], t["wq"], t["k"], t["v"], t["lens"], rope_theta=theta)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_fused_decode_block_matches_plain(cuda_device, dtype, tol):
    t = _inputs(cuda_device, dtype)
    args = (t["x1"], t["wq"], t["k"], t["v"], t["wo"], t["res"], t["lens"])
    got = fused_decode_block(*args, rope_theta=1e4)
    want = fused_decode_block_plain(*args, rope_theta=1e4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, fused_decode_block(*args, rope_theta=1e4))
    assert torch.equal(got[0], t["res"][0])       # the length-0 row


# The decode megakernels' bf16 body (b, hq, hkv, e, d): B = 1, 4, 9 and
# 17 (one, two and three n-tiles of 8 rows) and 33 (two passes of 32
# rows); GQA groups 1, 5, 9 and 12, so Hq is no multiple of the phases'
# runs per block; E = 4608 (the serve path's) and 200, 333 (off the
# 64-row units and the 128-column tiles; 333 also off the 16-byte copies:
# plain loads of x and Wo); D = 128 (the _d128 instantiation), 64, 40
# (off the 16-wide steps) and 36 (plain loads of Wq and K/V)
DECODE_CASES = [
    (1, 36, 4, 4608, 128), (4, 36, 4, 4608, 128), (9, 45, 9, 4608, 128),
    (17, 12, 1, 200, 64), (4, 9, 9, 333, 128), (33, 18, 2, 512, 128),
    (3, 10, 2, 256, 40), (2, 4, 2, 96, 36)]
#: per-row lengths, cycled: 0, one key, a page edge (16), the 64-key tile
#: and chunk edges (64, 65, 128), 447, and the whole cache
DECODE_LENS = [0, 1, 16, 64, 65, 128, 447, 512]


def _decode_inputs(dev, dtype, b, hq, hkv, e, d, skv=512, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                               * scale).to(dtype)
    lens = [DECODE_LENS[(i * 3) % len(DECODE_LENS)] for i in range(b)]
    lens[-1] = skv if b > 1 else 447
    return dict(x=r(b, 1, e), wq=r(e, hq, d, scale=e ** -0.5),
                k=r(b, hkv, skv, d), v=r(b, hkv, skv, d),
                wo=r(hq, d, e, scale=(hq * d) ** -0.5), res=r(b, 1, e),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev))


def _row_rel(got, want):
    """max over rows of max |got - want| / max |want| of the row, with a
    row whose want is all zeros held to exact zeros."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    err = (got - want).abs().amax(1)
    scale = want.abs().amax(1)
    return max(float(e / s) if s > 0 else float(e) * 1e30
               for e, s in zip(err, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,e,d", DECODE_CASES)
def test_decode_block_bf16_body_matches_plain_and_dense(cuda_device, b, hq,
                                                        hkv, e, d):
    """The bf16 body of #3 and #6: against the plain version per row at
    2e-2 of the row (with a zero residual, so the check sees o @ Wo
    itself), a length-0 row returning its residual exactly, bitwise
    repeatable, and #6 over pools of pages of 8 and 16 equal to #3 on the
    gathered cache bit for bit."""
    t = _decode_inputs(cuda_device, torch.bfloat16, b, hq, hkv, e, d)
    zero = torch.zeros_like(t["res"])
    args = lambda res: (t["x"], t["wq"], t["k"], t["v"], t["wo"], res,
                        t["lens"])
    got0 = fused_decode_block(*args(zero), rope_theta=1e4)
    want0 = fused_decode_block_plain(*args(zero), rope_theta=1e4)
    assert torch.isfinite(got0.float()).all()
    assert _row_rel(got0, want0) <= 2e-2
    got = fused_decode_block(*args(t["res"]), rope_theta=1e4)
    torch.testing.assert_close(
        got.float(), fused_decode_block_plain(*args(t["res"]),
                                              rope_theta=1e4).float(),
        rtol=2e-2, atol=2e-2)
    assert torch.equal(got, fused_decode_block(*args(t["res"]),
                                               rope_theta=1e4))
    dead = [i for i, n in enumerate(t["lens"].tolist()) if n == 0]
    assert torch.equal(got[dead], t["res"][dead])
    for page in (8, 16):
        kp, vp, tbl, kd, vd = _paged(t["k"], t["v"], page, dead=dead)
        paged = fused_decode_block_paged(t["x"], t["wq"], kp, vp, t["wo"],
                                         t["res"], t["lens"], tbl,
                                         rope_theta=1e4)
        assert torch.equal(paged, got)
    # without RoPE, and at another scale
    got = fused_decode_block(*args(zero), scale=0.05)
    assert _row_rel(got, fused_decode_block_plain(*args(zero),
                                                  scale=0.05)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,e,d", DECODE_CASES[1:2] + DECODE_CASES[6:])
def test_decode_block_fp32_keeps_the_fma_body(cuda_device, b, hq, hkv, e, d):
    """fp32 inputs run the FMA body, held to 1e-4 of the plain version."""
    t = _decode_inputs(cuda_device, torch.float32, b, hq, hkv, e, d)
    args = (t["x"], t["wq"], t["k"], t["v"], t["wo"], t["res"], t["lens"])
    torch.testing.assert_close(
        fused_decode_block(*args, rope_theta=1e4),
        fused_decode_block_plain(*args, rope_theta=1e4), rtol=1e-4,
        atol=1e-4)


@pytest.mark.cuda
def test_decode_block_workspace_is_kept_and_left_clear(cuda_device):
    """A second call of one shape reuses the first call's workspace and
    allocates nothing on the card; its tickets are zero after each call
    and its grid barrier's count of arrivals, which only counts up, is a
    multiple of the grid, so the calls agree bit for bit across shapes
    in turn."""
    from repro_torch.kernels import fused_decode_block as fdb
    a = _decode_inputs(cuda_device, torch.bfloat16, *DECODE_CASES[1])
    c = _decode_inputs(cuda_device, torch.bfloat16, *DECODE_CASES[3])
    run = lambda t: fused_decode_block(t["x"], t["wq"], t["k"], t["v"],
                                       t["wo"], t["res"], t["lens"],
                                       rope_theta=1e4)
    first_a, first_c = run(a), run(c)
    torch.cuda.synchronize()
    kept = len(fdb._WORKSPACES)
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        assert torch.equal(run(a), first_a)
        assert torch.equal(run(c), first_c)
    torch.cuda.synchronize()
    assert len(fdb._WORKSPACES) == kept
    assert torch.cuda.memory_allocated() == before
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    checked = 0
    for key, ws in fdb._WORKSPACES.items():
        if key[3] == "mma" and key[-1] == n_sms:
            plan = fdb.decode_plan(*key[4:])
            assert ws.numel() == plan.workspace_bytes
            arrivals = ws[:8].view(torch.int64).item()
            assert arrivals > 0 and arrivals % plan.n_blocks == 0
            assert not ws[256:plan.counter_bytes].any()   # tickets
            checked += 1
    assert checked >= 2


@pytest.mark.cuda
def test_decode_block_phase_trace(cuda_device):
    """A traced launch (fused_decode_block.PHASE_TRACE) gives the output
    an untraced one gives, stamps every block's phases in order, and no
    block passes a grid barrier before every block has reached it."""
    from repro_torch.kernels import fused_decode_block as fdb
    t = _decode_inputs(cuda_device, torch.bfloat16, *DECODE_CASES[1])
    args = (t["x"], t["wq"], t["k"], t["v"], t["wo"], t["res"], t["lens"])
    want = fused_decode_block(*args, rope_theta=1e4)
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    trace = torch.zeros((fdb.STAMPS, n_sms), dtype=torch.int64,
                        device=cuda_device)
    fdb.PHASE_TRACE = trace
    try:
        got = fused_decode_block(*args, rope_theta=1e4)
    finally:
        fdb.PHASE_TRACE = None
    assert torch.equal(got, want)
    tr = trace.cpu()
    every = [0, 1, 2, 6, 7, 8]      # stamps that every block writes
    assert (tr[every] > 0).all()
    for i, j in zip(every, every[1:]):
        assert (tr[j] >= tr[i]).all()
    assert tr[2].min() >= tr[1].max()   # barrier (a)
    assert tr[7].min() >= tr[6].max()   # barrier (b)


def _paged(k, v, page, seed=0, dead=()):
    """The dense (B, Hkv, Skv, D) caches k, v, padded to whole pages and
    scattered into random pools of more pages than they need, through a
    shuffled (B, max_pages) int32 table; rows in ``dead`` get an
    all-zero table row.  Returns (k pool, v pool, table, padded k,
    padded v) with gather_pages(pool, table) == padded cache on the
    live rows."""
    b, hkv, skv, d = k.shape
    max_pages = -(-skv // page)
    pad = max_pages * page - skv
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    g = torch.Generator(device=k.device).manual_seed(seed)
    n_pages = b * max_pages + 7
    ids = torch.randperm(n_pages - 1, generator=g, device=k.device) + 1
    tbl = ids[:b * max_pages].reshape(b, max_pages).to(torch.int32)

    def pool(x):
        out = torch.randn(n_pages, hkv, page, d, generator=g,
                          device=x.device).to(x.dtype)
        out[tbl.flatten().long()] = x.reshape(
            b, hkv, max_pages, page, d).movedim(2, 1).reshape(-1, hkv, page, d)
        return out

    kp, vp = pool(k), pool(v)
    tbl[list(dead)] = 0
    return kp, vp, tbl.contiguous(), k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("page", [8, 40, 128])
def test_paged_kernels_match_plain_and_dense(cuda_device, dtype, tol, page):
    t = _inputs(cuda_device, dtype)
    kp, vp, tbl, k, v = _paged(t["k"], t["v"], page, dead=(0,))
    assert torch.equal(ref.gather_pages(kp, tbl)[1:], k[1:])
    lens = t["lens"]                                  # row 0: length 0
    cases = [
        (lambda: fused_attention_paged(t["q"], kp, vp, lens, tbl),
         lambda: fused_attention_paged_plain(t["q"], kp, vp, lens, tbl),
         lambda: fused_attention_masked(t["q"], k, v, lens)),
        (lambda: fused_qproj_attention_paged(t["x"], t["wq"], kp, vp, lens,
                                             tbl, rope_theta=1e4),
         lambda: fused_qproj_attention_paged_plain(
             t["x"], t["wq"], kp, vp, lens, tbl, rope_theta=1e4),
         lambda: fused_qproj_attention_masked(t["x"], t["wq"], k, v, lens,
                                              rope_theta=1e4)),
        (lambda: fused_decode_block_paged(t["x1"], t["wq"], kp, vp, t["wo"],
                                          t["res"], lens, tbl,
                                          rope_theta=1e4),
         lambda: fused_decode_block_paged_plain(
             t["x1"], t["wq"], kp, vp, t["wo"], t["res"], lens, tbl,
             rope_theta=1e4),
         lambda: fused_decode_block(t["x1"], t["wq"], k, v, t["wo"],
                                    t["res"], lens, rope_theta=1e4)),
    ]
    for kernel, plain, dense in cases:
        got = kernel()
        torch.testing.assert_close(got.float(), plain().float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got, dense())


# batch rows, their lengths: a length-0 row (its table row zeros), a
# length of one key, one on a page edge (384 = 3 * 128), and 1023, whose
# chunks over every (row, KV head) need more blocks than the card has SMs
SPLIT_CASES = [(4, [0, 1, 384, 1023]), (2, [384, 1023])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,lens", SPLIT_CASES)
@pytest.mark.parametrize("page", [8, 16, 128])
def test_split_decode_matches_plain_and_dense(cuda_device, dtype, tol, b,
                                              lens, page):
    """#4 at qwen3-8b's widths and M=1 runs the split-KV body: within
    tolerance of its plain version, bitwise equal to #1 (the same body,
    dense) on the gathered cache and to itself on a second call, and
    zeros for a length-0 row."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda_device).to(dtype)
    hq, hkv, d, skv = 32, 8, 128, 1024
    q, k, v = r(b, hq, 1, d), r(b, hkv, skv, d), r(b, hkv, skv, d)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n_sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    n_chunks = split_chunks(b, hq, hkv, 1, n_sms, dtype)
    assert n_chunks > 0
    assert len(chunk_bounds(max(lens), n_chunks)) * b * hkv > n_sms
    zero = [i for i, n in enumerate(lens) if n == 0]
    kp, vp, tbl, kd, vd = _paged(k, v, page, dead=zero)
    got = fused_attention_paged(q, kp, vp, lengths, tbl)
    torch.testing.assert_close(
        got.float(), fused_attention_paged_plain(q, kp, vp, lengths,
                                                 tbl).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got, fused_attention_masked(q, kd, vd, lengths))
    assert torch.equal(got, fused_attention_paged(q, kp, vp, lengths, tbl))
    assert not got[zero].any()


# The masked bodies' one-pass shapes (b, hq, hkv, sq, skv, d, lengths):
# grids of at least 132 blocks even at 64 rows a block, so neither dtype
# takes the split-KV body; Sq off the 64-row grid, so a block's rows and
# one warp's 16 span two query heads (group * Sq rows flattened); lengths
# 0, 1 (rows before the prefix see nothing), 63, 64, 65 and the full
# cache; D = 128 (the serve path's _d128 instantiation), 64 and 40 (not
# a multiple of 16: zero-padded fragments)
MASKED_CASES = [
    (4, 32, 8, 70, 300, 128, [0, 1, 64, 300]),
    (4, 32, 8, 70, 200, 64, [63, 65, 200, 0]),
    (4, 32, 8, 70, 150, 40, [65, 150, 1, 64]),
    # hubert-xlarge's heads (16 of 80, no grouping), rows off the tile
    (4, 16, 16, 130, 200, 80, [0, 65, 130, 200]),
]


def _masked_inputs(dev, dtype, b, hq, hkv, sq, skv, d, lens, e=256):
    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                               * scale).to(dtype)
    return dict(q=r(b, hq, sq, d), k=r(b, hkv, skv, d), v=r(b, hkv, skv, d),
                x=r(b, sq, e), wq=r(e, hq, d, scale=e ** -0.5),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,lens", MASKED_CASES)
def test_masked_one_pass_bodies_match_plain(cuda_device, dtype, tol, b, hq,
                                            hkv, sq, skv, d, lens):
    """#1 and #2 at one-pass shapes: the tensor-core bodies in bf16 (2e-2)
    and the FMA bodies in fp32 (1e-4) against their plain versions,
    causal and not, with and without RoPE; bitwise repeatable; zeros for
    a length-0 row."""
    n_sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert split_chunks(b, hq, hkv, sq, n_sms, dtype) == 0
    t = _masked_inputs(cuda_device, dtype, b, hq, hkv, sq, skv, d, lens)
    zero = [i for i, n in enumerate(lens) if n == 0]
    for causal in (True, False):
        args = (t["q"], t["k"], t["v"], t["lens"])
        got = fused_attention_masked(*args, causal=causal)
        want = fused_attention_masked_plain(*args, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got, fused_attention_masked(*args, causal=causal))
        assert not got[zero].any()
        for theta in (1e4, None):
            args = (t["x"], t["wq"], t["k"], t["v"], t["lens"])
            got = fused_qproj_attention_masked(*args, causal=causal,
                                               rope_theta=theta)
            want = fused_qproj_attention_masked_plain(*args, causal=causal,
                                                      rope_theta=theta)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert torch.equal(got, fused_qproj_attention_masked(
                *args, causal=causal, rope_theta=theta))
            assert not got[zero].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("page", [8, 16, 128])
@pytest.mark.parametrize("case", [0, 2])
def test_masked_one_pass_paged_twins_equal_dense(cuda_device, dtype, tol,
                                                 page, case):
    """#4 and #5 at one-pass shapes, over shuffled tables (a dead row whose
    table row is zeros): within tolerance of their plain versions and bit
    for bit #1 and #2 on the gathered cache (one body, another KV
    address)."""
    b, hq, hkv, sq, skv, d, lens = MASKED_CASES[case]
    lens = [0] + lens[1:]                            # row 0: dead, length 0
    t = _masked_inputs(cuda_device, dtype, b, hq, hkv, sq, skv, d, lens)
    kp, vp, tbl, k, v = _paged(t["k"], t["v"], page, dead=(0,))
    ln = t["lens"]
    got = fused_attention_paged(t["q"], kp, vp, ln, tbl)
    torch.testing.assert_close(
        got.float(), fused_attention_paged_plain(t["q"], kp, vp, ln,
                                                 tbl).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got, fused_attention_masked(t["q"], k, v, ln))
    got = fused_qproj_attention_paged(t["x"], t["wq"], kp, vp, ln, tbl,
                                      rope_theta=1e4)
    torch.testing.assert_close(
        got.float(), fused_qproj_attention_paged_plain(
            t["x"], t["wq"], kp, vp, ln, tbl, rope_theta=1e4).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got, fused_qproj_attention_masked(
        t["x"], t["wq"], k, v, ln, rope_theta=1e4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,sq,page", [(4, 1, 16), (2, 3, 8)])
def test_qproj_paged_decode_rows_match_plain_and_dense(cuda_device, dtype,
                                                       tol, b, sq, page):
    """#5 on the rung-down decode path (M=1, 63 of a block's 64 rows
    padding) and a 3-row chunk at D = 128: within tolerance of its plain
    version and bit for bit #2 on the gathered cache."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    r = lambda *s, scale=1.0: (torch.randn(
        *s, generator=g, device=cuda_device) * scale).to(dtype)
    hq, hkv, d, skv, e = 12, 4, 128, 400, 320
    x, wq = r(b, sq, e), r(e, hq, d, scale=e ** -0.5)
    k, v = r(b, hkv, skv, d), r(b, hkv, skv, d)
    lens = torch.tensor([301, 0, 399, 64][:b], dtype=torch.int32,
                        device=cuda_device)
    kp, vp, tbl, kd, vd = _paged(k, v, page)
    got = fused_qproj_attention_paged(x, wq, kp, vp, lens, tbl,
                                      rope_theta=1e4)
    torch.testing.assert_close(
        got.float(), fused_qproj_attention_paged_plain(
            x, wq, kp, vp, lens, tbl, rope_theta=1e4).float(),
        rtol=tol, atol=tol)
    assert torch.equal(got, fused_qproj_attention_masked(
        x, wq, kd, vd, lens, rope_theta=1e4))


@pytest.mark.cuda
def test_paged_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    t = _inputs(cuda_device, torch.bfloat16)
    kp, vp, tbl, _, _ = _paged(t["k"], t["v"], 8)
    with pytest.raises(ValueError, match="int32"):
        fused_attention_paged(t["q"], kp, vp, t["lens"], tbl.long())
    with pytest.raises(ValueError, match="int32"):
        fused_attention_paged(t["q"], kp, vp, t["lens"], tbl.cpu())
    kp12, vp12, tbl12, _, _ = _paged(t["k"], t["v"], 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_decode_block_paged(t["x1"], t["wq"], kp12, vp12, t["wo"],
                                 t["res"], t["lens"], tbl12)


@pytest.mark.cuda
def test_launches_are_counted(cuda_device):
    t = _inputs(cuda_device, torch.bfloat16)
    kp, vp, tbl, _, _ = _paged(t["k"], t["v"], 8)
    build.reset_launches()
    fused_attention_masked(t["q"], t["k"], t["v"], t["lens"])
    fused_qproj_attention_masked(t["x"], t["wq"], t["k"], t["v"], t["lens"])
    fused_decode_block(t["x1"], t["wq"], t["k"], t["v"], t["wo"], t["res"],
                       t["lens"])
    fused_attention_paged(t["q"], kp, vp, t["lens"], tbl)
    fused_qproj_attention_paged(t["x"], t["wq"], kp, vp, t["lens"], tbl)
    fused_decode_block_paged(t["x1"], t["wq"], kp, vp, t["wo"], t["res"],
                             t["lens"], tbl)
    # the training kernels: a forward and a backward of each schedule
    # (fused_qproj_attention's backward reuses #8/#9: counted twice)
    q, k, v = (x.clone().requires_grad_() for x in (t["q"], t["k"], t["v"]))
    fused_attention(q, k, v).sum().backward()
    x, wq = t["x"].clone().requires_grad_(), t["wq"].clone()
    fused_qproj_attention(x, wq, t["k"], t["v"], rope_theta=1e4).sum() \
        .backward()
    # and the Mamba-2 SSD scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    s = _ssd_inputs(cuda_device, torch.bfloat16, 1, 128, 2, 64, 1, 32)
    ssd_scan(s["x"], s["dt"], s["a"], s["b"], s["c"], s["d"], chunk=128)
    torch.cuda.synchronize()
    twice = {"fused_attention_bwd_dq", "fused_attention_bwd_dkv"}
    assert {n: build.LAUNCHES[n] for n in build.KERNELS} == {
        n: 2 if n in twice else 1 for n in build.KERNELS}


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(cuda_device):
    t = _inputs(cuda_device, torch.bfloat16)
    with pytest.raises(ValueError):
        fused_attention_masked(t["q"], t["k"].cpu(), t["v"], t["lens"])


@pytest.mark.cuda
def test_build_all_compiles_every_kernel(cuda_device):
    build.build_all()
    for name in build.KERNELS:
        assert build.library_path(name).exists()
        assert build.kernel(name) is not None


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


# b, hq, hkv, sq, skv, d, dv, causal, q_offset
TRAIN_CASES = [
    (2, 9, 3, 200, 200, 64, 64, True, None),    # off the 16/32/64 grids
    (1, 4, 4, 120, 200, 64, 32, True, None),    # Sq < Skv, Dv != D
    (2, 6, 2, 96, 160, 32, 32, True, 40),       # explicit causal offset
    (1, 6, 2, 77, 130, 64, 64, False, None),    # full attention
    # the edges of the tensor-core bodies' 64-row and 64-key tiles
    (1, 2, 1, 64, 64, 64, 64, True, None),      # one whole tile
    (1, 2, 1, 65, 65, 64, 64, True, None),      # one row and key past it
    (1, 9, 1, 257, 257, 128, 128, True, None),  # group of 9, D = 128
    (2, 4, 2, 1, 130, 64, 64, True, None),      # one row against 130 keys
    (1, 4, 2, 100, 100, 40, 40, True, None),    # D not a multiple of 16
    (1, 4, 2, 70, 70, 36, 36, True, None),      # ... nor of 8: plain loads
    (1, 4, 2, 150, 150, 128, 64, True, None),   # D = 128, Dv = 64
    # rows that see no column (o = 0, lse = -1e30), keys no row sees
    (1, 4, 2, 130, 70, 64, 64, True, None),     # Sq > Skv: rows 0..59
    (1, 4, 2, 200, 150, 64, 64, True, -100),    # a whole tile of each
    # hubert-xlarge's heads: non-causal, D = Dv = 80, 16 of 16, lengths
    # off the 64-row and 64-key tiles (the _any instantiations)
    (1, 16, 16, 200, 200, 80, 80, False, None),
    (2, 16, 16, 130, 260, 80, 80, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,q_offset",
                         TRAIN_CASES)
def test_training_attention_kernels_match_plain(cuda_device, dtype, tol, b,
                                                hq, hkv, sq, skv, d, dv,
                                                causal, q_offset):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda_device).to(dtype)
    q, k, v, do = r(b, hq, sq, d), r(b, hkv, skv, d), r(b, hkv, skv, dv), \
        r(b, hq, sq, dv)
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = fused_attention_fwd(q, k, v, **kw)
    o_p, lse_p = fused_attention_fwd_plain(q, k, v, **kw)
    assert lse.dtype == torch.float32
    assert _rel(o, o_p) <= tol and _rel(lse, lse_p) <= tol
    # row r sees keys up to reach + r; a row that sees no column emits
    # o = 0 and lse = -1e30
    reach = causal_anchor(q_offset, sq, skv) if causal else skv - 1
    blind = reach + torch.arange(sq, device=cuda_device) < 0
    assert torch.equal(o[:, :, blind], torch.zeros_like(o[:, :, blind]))
    assert bool((lse[:, :, blind] == -1e30).all())
    delta = (o_p.float() * do.float()).sum(-1)
    dq = fused_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dvv = fused_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    want = (fused_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fused_attention_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
    for got, w in zip((dq, dk, dvv), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert _rel(got, w) <= tol
    # keys past the last row's anchor get no gradient
    unseen = torch.arange(skv, device=cuda_device) > reach + sq - 1
    assert not dk[:, :, unseen].any() and not dvv[:, :, unseen].any()
    # deterministic: no atomics in the dk/dv group sum, one writer per
    # dq element
    again = fused_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dvv)
    assert torch.equal(fused_attention_bwd_dq(q, k, v, do, lse_p, delta,
                                              **kw), dq)


@pytest.mark.cuda
def test_bf16_training_bodies_run_on_the_tensor_cores(cuda_device):
    # sass_hmma raises, so the test fails, if cuobjdump is missing
    build.build_all(list(build.TENSOR_CORE_BODIES))
    for name, symbols in build.TENSOR_CORE_BODIES.items():
        for symbol in symbols:          # each width instantiation
            assert build.sass_hmma(name, symbol) > 0, \
                f"{name}: no HMMA in {symbol}'s SASS"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("theta,q_offset", [(1e4, None), (None, None),
                                            (1e4, 30)])
def test_qproj_training_kernels_match_plain(cuda_device, dtype, tol, theta,
                                            q_offset):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    r = lambda *s, scale=1.0: (torch.randn(
        *s, generator=g, device=cuda_device) * scale).to(dtype)
    b, hq, hkv, sq, skv, e, d = 2, 6, 2, 100, 130, 96, 64
    x, wq = r(b, sq, e), r(e, hq, d, scale=e ** -0.5)
    k, v, do = r(b, hkv, skv, d), r(b, hkv, skv, d), r(b, hq, sq, d)
    kw = dict(causal=True, q_offset=q_offset, rope_theta=theta)
    o, lse = fused_qproj_attention_fwd(x, wq, k, v, **kw)
    o_p, lse_p = fused_qproj_attention_fwd_plain(x, wq, k, v, **kw)
    assert _rel(o, o_p) <= tol and _rel(lse, lse_p) <= tol
    again = fused_qproj_attention_fwd(x, wq, k, v, **kw)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, wq, k, v)]
        fused_qproj_attention(*leaves, plain=plain, **kw).backward(do)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("e,d,sq,skv", [(256, 128, 130, 130),
                                        (96, 40, 100, 120),
                                        (100, 36, 70, 70)])
def test_qproj_fwd_widths_match_plain(cuda_device, dtype, tol, e, d, sq, skv):
    """#10 at D = 128 (RoPE in registers), 40 (not a multiple of 16) and
    36 with E = 100 (neither a multiple of 8: x, Wq, K and V by plain
    loads): o and lse against the plain version, bitwise repeatable, the
    rows before the prefix (Sq > Skv - q_offset) emitting zeros."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    r = lambda *s, scale=1.0: (torch.randn(
        *s, generator=g, device=cuda_device) * scale).to(dtype)
    b, hq, hkv = 2, 6, 2
    x, wq = r(b, sq, e), r(e, hq, d, scale=e ** -0.5)
    k, v = r(b, hkv, skv, d), r(b, hkv, skv, d)
    kw = dict(causal=True, q_offset=-3, rope_theta=1e4)
    o, lse = fused_qproj_attention_fwd(x, wq, k, v, **kw)
    o_p, lse_p = fused_qproj_attention_fwd_plain(x, wq, k, v, **kw)
    assert _rel(o, o_p) <= tol and _rel(lse, lse_p) <= tol
    again = fused_qproj_attention_fwd(x, wq, k, v, **kw)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    assert not o[:, :, :3].any() and bool((lse[:, :, :3] == -1e30).all())


@pytest.mark.cuda
def test_one_layer_backward_on_the_kernels_reaches_qkv(cuda_device):
    """A cache-free forward and backward through a one-layer model on the
    card gives wq, wk and wv a non-zero gradient: the training attention
    is differentiable on the kernels."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import init_params
    cfg = dataclasses.replace(configs.get_config("starcoder2-7b", smoke=True),
                              n_layers=1, compute_dtype="bfloat16",
                              param_dtype="bfloat16")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    attn = params["layers"][0]["attn"]
    for key in ("wq", "wk", "wv"):
        attn[key].requires_grad_()
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda_device)
    build.reset_launches()
    tf.forward(params, cfg, toks).float().square().mean().backward()
    torch.cuda.synchronize()
    for key in ("wq", "wk", "wv"):
        grad = attn[key].grad
        assert grad is not None and grad.abs().max().item() > 0, key
    assert build.LAUNCHES["fused_attention_fwd"] == 1
    assert build.LAUNCHES["fused_attention_bwd_dq"] == 1
    assert build.LAUNCHES["fused_attention_bwd_dkv"] == 1


@pytest.mark.cuda
def test_serve_kernels_refuse_a_tensor_that_requires_grad(cuda_device):
    t = _inputs(cuda_device, torch.bfloat16)
    q = t["q"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="require grad"):
        fused_attention_masked(q, t["k"], t["v"], t["lens"])
    with torch.no_grad():
        fused_attention_masked(q, t["k"], t["v"], t["lens"])


# B, L, H, P, G, S, chunk, with h0
SSD_CASES = [
    (1, 188, 24, 64, 1, 128, 128, True),    # the serve path's prefill chunk
    (2, 256, 4, 64, 2, 128, 64, False),     # on the chunk grid, G = 2
    (2, 75, 8, 32, 4, 64, 32, True),        # off the grid, G = 4
    (1, 128, 2, 64, 1, 32, 128, False),     # one chunk
    # the bf16 body: 16 chunks (the cache-free forward's shape), head
    # tiles that do not divide H/G at G = 1, 2 and 4 (tests/
    # test_torch_ssd_plan.py holds them so), one ragged chunk at P = 32
    (4, 2048, 24, 64, 1, 128, 128, False),
    (1, 2048, 9, 64, 1, 128, 128, True),
    (2, 300, 16, 64, 2, 128, 64, True),
    (2, 300, 20, 64, 4, 128, 64, False),
    (1, 100, 4, 32, 1, 128, 128, True),
]
#: the bf16 body's cases held per row, also with dt scaled by 0.05 (a
#: long memory: the state carries across chunks): B, L, H, P, G, S, chunk
SSD_ROW_CASES = [(1, 188, 24, 64, 1, 128, 128), (4, 2048, 24, 64, 1, 128, 128),
                 (1, 2048, 9, 64, 1, 128, 128), (2, 300, 20, 64, 4, 128, 64),
                 (2, 75, 8, 32, 4, 64, 32)]


def _ssd_inputs(dev, dtype, B, L, H, P, G, S, seed=0, dt_scale=0.1):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    return dict(x=r(B, L, H, P).to(dtype),
                dt=(torch.nn.functional.softplus(r(B, L, H))
                    * dt_scale).to(dtype),
                a=-torch.exp(r(H)), b=(r(B, L, G, S) * 0.3).to(dtype),
                c=(r(B, L, G, S) * 0.3).to(dtype), d=r(H),
                h0=r(B, H, P, S) * 0.5)


def _row_rel(got, want):
    """The largest, over the rows (the last dimension), of a row's max
    |got - want| over its max |want|."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("B,L,H,P,G,S,chunk,with_h0", SSD_CASES)
def test_ssd_scan_matches_plain(cuda_device, dtype, tol, B, L, H, P, G, S,
                                chunk, with_h0):
    """#11 against its plain version: y and the final state, relative to
    each one's largest magnitude (fp32 1e-4, bf16 2e-2: both compute in
    fp32 and round y once)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    t = _ssd_inputs(cuda_device, dtype, B, L, H, P, G, S)
    h0 = t["h0"] if with_h0 else None
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"])
    y, h = ssd_scan(*args, chunk=chunk, h0=h0, return_final_state=True)
    wy, wh = ssd_scan_plain(*args, chunk=chunk, h0=h0,
                            return_final_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert _rel(y, wy) <= tol and _rel(h, wh) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dt_scale", [1.0, 0.1, 0.05])
@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_ROW_CASES)
def test_ssd_scan_bf16_body_per_row(cuda_device, B, L, H, P, G, S, chunk,
                                    dt_scale):
    """The bf16 tensor-core body per (row, position, head) of y and per
    (row, head, P row) of the state, within 2e-2 of that row's largest
    |want|, with h0; at dt's full scale a steep decay leaves rows whose
    y cancels to near zero; with dt scaled by 0.05 the state carries
    across the chunks, so a dropped or stale incoming state would show."""
    from repro_torch.kernels.ssd_scan import (ssd_plan, ssd_scan,
                                              ssd_scan_plain)
    assert ssd_plan(B, L, H, P, G, S, chunk, 132) is not None
    t = _ssd_inputs(cuda_device, torch.bfloat16, B, L, H, P, G, S, seed=1,
                    dt_scale=dt_scale)
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"])
    y, h = ssd_scan(*args, chunk=chunk, h0=t["h0"], return_final_state=True)
    wy, wh = ssd_scan_plain(*args, chunk=chunk, h0=t["h0"],
                            return_final_state=True)
    torch.cuda.synchronize()
    assert _row_rel(y, wy) <= 2e-2 and _row_rel(h, wh) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_ROW_CASES[:3])
def test_ssd_scan_is_bitwise_repeatable(cuda_device, B, L, H, P, G, S,
                                        chunk):
    """y and the final state are the same bits on every call (fixed
    summation orders; the workspace is reused with a new epoch), and a
    zero h0 gives what no h0 gives."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    t = _ssd_inputs(cuda_device, torch.bfloat16, B, L, H, P, G, S, seed=2,
                    dt_scale=0.05)
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"])
    runs = [ssd_scan(*args, chunk=chunk, h0=t["h0"], return_final_state=True)
            for _ in range(3)]
    for y, h in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(h, runs[0][1])
    none = ssd_scan(*args, chunk=chunk, return_final_state=True)
    zero = ssd_scan(*args, chunk=chunk, h0=torch.zeros_like(t["h0"]),
                    return_final_state=True)
    assert torch.equal(none[0], zero[0]) and torch.equal(none[1], zero[1])


@pytest.mark.cuda
def test_ssd_scan_workspace_is_kept_per_stream(cuda_device):
    """One workspace per (device, stream), grown when a larger plan needs
    it; each launch takes the next epoch and its tickets after the last
    launch's; shapes alternating on it, and a launch on another stream
    (its own workspace), give what each gives alone."""
    from repro_torch.kernels import ssd_scan as sk
    H, P, G, S = 24, 64, 1, 128
    small = _ssd_inputs(cuda_device, torch.bfloat16, 1, 188, H, P, G, S,
                        seed=3)
    large = _ssd_inputs(cuda_device, torch.bfloat16, 2, 700, H, P, G, S,
                        seed=4)

    def run(t):
        return sk.ssd_scan(t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"],
                           chunk=128, h0=t["h0"], return_final_state=True)

    sk._WORKSPACES.clear()
    want_small = run(small)
    (key, (ws, epoch, drawn)), = sk._WORKSPACES.items()
    assert epoch == 1 and drawn == sk.ssd_plan(
        1, 188, H, P, G, S, 128, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count).n_items
    want_large = run(large)
    grown = sk._WORKSPACES[key][0]
    assert grown.numel() >= ws.numel() and sk._WORKSPACES[key][1] == 2
    for _ in range(2):
        for t, want in ((small, want_small), (large, want_large)):
            got = run(t)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    assert len(sk._WORKSPACES) == 1 and sk._WORKSPACES[key][0] is grown
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = run(small)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert len(sk._WORKSPACES) == 2 and torch.equal(got[0], want_small[0])


@pytest.mark.cuda
def test_ssd_scan_phase_trace(cuda_device):
    """A traced launch stamps every item's start and, per head of its
    tile, its phases in order; the traced result equals the untraced."""
    from repro_torch.kernels import ssd_scan as sk
    B, L, H, P, G, S = 1, 300, 24, 64, 1, 128
    t = _ssd_inputs(cuda_device, torch.bfloat16, B, L, H, P, G, S, seed=5)
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"])
    n_sm = torch.cuda.get_device_properties(cuda_device) \
        .multi_processor_count
    plan = sk.ssd_plan(B, L, H, P, G, S, 128, n_sm)
    want = sk.ssd_scan(*args, chunk=128, h0=t["h0"])
    sk.PHASE_TRACE = torch.zeros(
        (plan.n_items, 1 + sk.STAMPS_PER_HEAD * plan.ht), dtype=torch.int64,
        device=cuda_device)
    try:
        got = sk.ssd_scan(*args, chunk=128, h0=t["h0"])
        torch.cuda.synchronize()
        trace = sk.PHASE_TRACE.cpu()
    finally:
        sk.PHASE_TRACE = None
    assert torch.equal(got, want)
    for row, (_, _, _, _, nh, _) in zip(trace, sk.ssd_items(plan, B, H, G)):
        stamps = row[:1 + sk.STAMPS_PER_HEAD * nh]
        assert (stamps > 0).all() and (stamps[1:] >= stamps[:-1]).all()


@pytest.mark.cuda
def test_ssd_scan_reads_views_through_their_strides(cuda_device):
    """x, b and c as views into one wider tensor (the model's conv
    output) give the contiguous copies' result bit for bit; no d."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, L, H, P, S = 2, 150, 4, 64, 128
    wide = torch.randn(B, L, H * P + 2 * S + 5, generator=g,
                       device=cuda_device).to(torch.bfloat16)
    x = wide[..., :H * P].reshape(B, L, H, P)
    b = wide[..., H * P:H * P + S].reshape(B, L, 1, S)
    c = wide[..., H * P + S:H * P + 2 * S].reshape(B, L, 1, S)
    dt = torch.rand(B, L, H, generator=g, device=cuda_device) * 0.1
    a = -torch.rand(H, generator=g, device=cuda_device)
    got = ssd_scan(x, dt, a, b, c, chunk=128)
    want = ssd_scan(x.contiguous(), dt, a, b.contiguous(), c.contiguous(),
                    chunk=128)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ssd_scan_aligned_views_take_the_copies(cuda_device):
    """The conv output's layout of mamba2-130m (rows of H*P + 2*G*S,
    16-byte aligned: the bf16 body's cp.async path) against the
    contiguous copies, bit for bit, on both sides of the chunk grid."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, L, H, P, S = 2, 300, 24, 64, 128
    wide = torch.randn(B, L, H * P + 2 * S, generator=g,
                       device=cuda_device).to(torch.bfloat16)
    x = wide[..., :H * P].reshape(B, L, H, P)
    b = wide[..., H * P:H * P + S].reshape(B, L, 1, S)
    c = wide[..., H * P + S:].reshape(B, L, 1, S)
    dt = (torch.rand(B, L, H, generator=g, device=cuda_device) * 0.1) \
        .to(torch.bfloat16)
    a = -torch.rand(H, generator=g, device=cuda_device)
    d = torch.randn(H, generator=g, device=cuda_device)
    h0 = torch.randn(B, H, P, S, generator=g, device=cuda_device)
    got = ssd_scan(x, dt, a, b, c, d, chunk=128, h0=h0,
                   return_final_state=True)
    want = ssd_scan(x.contiguous(), dt, a, b.contiguous(), c.contiguous(),
                    d, chunk=128, h0=h0, return_final_state=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    t = _ssd_inputs(cuda_device, torch.float32, 1, 16, 2, 64, 1, 32)
    args = [t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"]]
    with pytest.raises(ValueError, match="outside"):
        ssd_scan(*args, chunk=256)
    with pytest.raises(ValueError, match="share"):
        ssd_scan(args[0], args[1], args[2], args[3].bfloat16(), args[4])
    args[0] = args[0].clone().requires_grad_()
    for impl in ("kernel", "cuda"):
        fn = ssd_scan if impl == "kernel" else functools.partial(
            ops.ssd, impl="cuda")
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(*args, chunk=16)
    # impl="auto" under autograd takes the plain scan (the JAX package's
    # differentiable lax scan off the TPU), counted as such
    ops.reset_counts()
    ops.ssd(*args, chunk=16)
    assert ops.CALLS[("ssd", "torch")] == 1 and not ops.CALLS[("ssd", "cuda")]


@pytest.mark.cuda
def test_two_layer_mamba2_forward_on_the_kernel(cuda_device):
    """mamba2-130m at full width, 2 layers, bf16: the cache-free logits
    and a cached two-chunk prefill on #11 against the plain versions
    (5e-2 of the largest logit), with one launch per layer and call."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import init_params
    cfg = dataclasses.replace(configs.get_config("mamba2-130m"), n_layers=2)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=g,
                         device=cuda_device)
    with torch.no_grad():
        ops.reset_counts()
        got = tf.forward(params, cfg, toks)
        assert build.LAUNCHES["ssd_scan"] == 2
        want = tf.forward(params, cfg, toks, impl="torch")
        assert _rel(got, want) <= 5e-2
        caches = [tf.init_model_cache(cfg, 2, 300, torch.bfloat16,
                                      cuda_device) for _ in range(2)]
        outs = []
        for impl, cache in zip(("auto", "torch"), caches):
            for start in (0, 200):
                lg, cache = tf.forward(params, cfg, toks[:, start:start + 200],
                                       cache=cache, cache_len=start,
                                       impl=impl)
            outs.append(lg)
        assert build.LAUNCHES["ssd_scan"] == 2 + 4
        assert _rel(outs[0], outs[1]) <= 5e-2
        assert _rel(outs[0][:, -1], got[:, -1]) <= 5e-2
        s0, s1 = (c["scan"][0]["mamba"]["ssm"] for c in caches)
        assert _rel(s0, s1) <= 5e-2


@pytest.mark.cuda
def test_supervisor_rungs_the_decode_megakernel_down_on_the_card(
        cuda_device):
    """The dense engine under the supervisor, starcoder2-7b smoke in fp32
    past C = 2N = 64: an injected ``cuda`` kernel fault (times=1) at a
    decode step stops #3 before its launch; the retry runs one rung down
    (#2 at M=1) for that step and the next two, cooloff brings #3 back,
    and the tokens are the fault-free run's."""
    import collections

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.weights import init_params
    from repro_torch.serve import (ContinuousBatchingEngine, FaultInjector,
                                   FaultSpec, Request, RequestBatcher,
                                   ServingSupervisor, make_serving_plan)
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    # three chunks of at most 32: both rows are live from step 2 on
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g,
                             device=cuda_device).tolist() for n in (70, 80)]

    def run(inj):
        eng = ContinuousBatchingEngine(
            params, cfg, batch_size=2, max_len=128,
            plan=make_serving_plan(cfg, 128, device=cuda_device),
            prefill_chunk=32, device=cuda_device)
        bat = RequestBatcher(2, max_len=128)
        for uid, p in enumerate(prompts):
            bat.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
        sup = ServingSupervisor(eng, bat, injector=inj, cooloff=2,
                                audit_every=1)
        per_step, step = [], sup.step

        def traced():
            before = collections.Counter(ops.CALLS)
            step()
            per_step.append(collections.Counter(ops.CALLS) - before)

        sup.step = traced
        fin = sup.serve(max_steps=40)
        return {r.uid: r.generated for r in fin}, per_step, sup, eng

    want, base, _, _ = run(None)
    build.reset_launches()
    inj = FaultInjector([FaultSpec("kernel", step=4, impl="cuda", times=1)])
    got, per_step, sup, eng = run(inj)
    assert inj.fired == [(4, "kernel", "decode_block/cuda")]
    assert got == want
    layers = cfg.n_layers
    assert all(base[t][("decode_block", "cuda")] == layers
               for t in range(2, len(base)))
    for t in (4, 5, 6):                      # the demoted steps: #2, M=1
        assert per_step[t][("qproj_attention", "cuda")] == layers
        assert ("decode_block", "cuda") not in per_step[t]
    assert all(per_step[t][("decode_block", "cuda")] == layers
               for t in range(7, len(per_step)))
    assert build.LAUNCHES["fused_decode_block"] == \
        layers * (len(per_step) - 2 - 3)
    assert build.LAUNCHES["fused_qproj_attention_masked"] >= 3 * layers
    assert [(i.step, i.action) for i in sup.ledger.incidents] == [
        (4, "rung-down to demotion level 1"), (4, "decode retry succeeded"),
        (6, "demotion decayed to 0")]
    assert any("kernel-failure recovery" in dg.reason
               for dg in eng.last_dispatch.plan.downgrades)
    assert eng.demotions == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,group", [("qwen3-14b", 5),
                                        ("starcoder2-15b", 12)])
def test_new_gqa_group_serves_on_the_kernels(cuda_device, arch, group):
    """qwen3-14b (40 query heads over 8 KV heads) and starcoder2-15b (48
    over 4) at full width, cut to one layer, bf16: one 300-token prompt
    (a 256-row chunk, then 44 rows past C = 2N) and four decode steps
    on the dense engine with its plan lowered by the DSE, against the
    same steps on the plain versions (a plan on the CPU device) within
    5e-2 of the largest logit.  starcoder2-15b runs #1, #2 and #3;
    qwen3-14b's qk-norm walks its Q-fusion rungs down to #1, recorded
    on the plan."""
    import dataclasses

    from repro_torch import configs, lower
    from repro_torch.models.weights import init_params
    from repro_torch.serve import ContinuousBatchingEngine
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=1)
    assert cfg.n_heads // cfg.kv_heads == group
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=g,
                           device=cuda_device).tolist()
    runs = []
    for plan_dev in (cuda_device, torch.device("cpu")):
        plan = lower.ServingPlan(cfg=cfg, max_len=512, device=plan_dev,
                                 n_blocks=cfg.n_layers)
        eng = ContinuousBatchingEngine(params, cfg, batch_size=1,
                                       max_len=512, plan=plan,
                                       dtype=torch.bfloat16,
                                       prefill_chunk=256, device=cuda_device)
        build.reset_launches()
        eng.begin_prefill(0, prompt)
        while not eng.live[0]:
            eng._advance_prefills()
        logits, fed = [eng.prefill_logits[0].float()], []
        for i in range(4):
            if runs:
                eng.state.last_token[0] = runs[0][1][i]
            fed.append(int(eng.state.last_token[0]))
            eng.decode_once()
            logits.append(eng.last_logits[0].float())
        runs.append((logits, fed, dict(build.LAUNCHES), plan))
    (got, _, launches, plan), (want, _, plain, _) = runs
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item()
    assert not plain
    assert all(p.source is not None and len({b.kernel_path
                                             for b in p.blocks}) == 1
               for p in plan._plans.values())
    assert launches["fused_attention_masked"] >= 1
    if cfg.qk_norm:
        assert set(launches) == {"fused_attention_masked"}
        assert any("qk-norm" in d.reason for d in plan.downgrades())
    else:
        assert launches["fused_qproj_attention_masked"] == 1
        assert launches["fused_decode_block"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("remat,fwd", [("none", 1), ("full", 2),
                                       ("dots", 2)])
def test_hubert_trains_on_the_kernels_under_each_remat(cuda_device, remat,
                                                       fwd):
    """hubert-xlarge at full width (16 heads of 80, non-causal), cut to
    2 layers, bf16: the loss and every gradient of one {"embeds",
    "targets"} batch of 2 x 300 frames on the kernels against the plain
    versions (loss within 1e-2 relative, each leaf within 2e-2 of its
    largest).  #7 launches once a layer, twice under "full" and "dots"
    (it runs outside the dispatcher, so the selective checkpoint
    recomputes it), #8 and #9 once a layer."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.models.weights import init_params
    from repro_torch.train import step
    cfg = dataclasses.replace(configs.get_config("hubert-xlarge"),
                              n_layers=2, remat=remat)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    batch = {"embeds": torch.randn(2, 300, cfg.frontend_dim, generator=g,
                                   device=cuda_device).to(torch.bfloat16),
             "targets": torch.randint(0, cfg.vocab_size, (2, 300),
                                      generator=g, device=cuda_device)}
    build.reset_launches()
    (loss, _), grads = step.value_and_grad(params, cfg, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {
        "fused_attention_fwd": fwd * cfg.n_layers,
        "fused_attention_bwd_dq": cfg.n_layers,
        "fused_attention_bwd_dkv": cfg.n_layers}
    build.reset_launches()
    (want, _), plain = step.value_and_grad(params, cfg, batch, impl="torch")
    assert not build.LAUNCHES
    assert abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())
    for a, b in zip(tree.leaves(grads), tree.leaves(plain)):
        assert torch.isfinite(a.float()).all()
        assert _rel(a, b) <= 2e-2


@pytest.mark.cuda
def test_vlm_serves_patch_embeddings_on_the_kernels(cuda_device):
    """internvl2-2b at full width, cut to one layer, bf16: 256 patch rows
    before 44 text tokens (B = 2) prefilled with the serving plan
    (#1 over 300 rows), then four decode steps (#3 past C = 2N), against
    the same steps on the plain versions within 5e-2 of the largest
    logit; the prefill's ``cache_len`` counts the patch rows."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.internvl2_2b import PATCH_TOKENS
    from repro_torch.models.weights import init_params
    from repro_torch.serve import engine
    cfg = dataclasses.replace(configs.get_config("internvl2-2b"), n_layers=1)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    emb = torch.randn(2, PATCH_TOKENS, cfg.frontend_dim, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=g,
                         device=cuda_device)
    plan = engine.make_serving_plan(cfg, 512, device=cuda_device)
    runs = []
    with torch.no_grad():
        for impl in ("auto", "torch"):
            state = engine.init_decode_state(cfg, 2, 512, torch.bfloat16,
                                             plan=plan, device=cuda_device)
            build.reset_launches()
            state = engine.prefill(params, cfg, toks, state, embeds=emb,
                                   plan=plan, impl=impl)
            assert state.cache_len.tolist() == [300, 300]
            logits = []
            for i in range(4):
                if runs:
                    state.last_token.copy_(runs[0][1][i])
                fed = state.last_token.clone()
                state, lg = engine.decode_step(params, cfg, state,
                                               plan=plan, impl=impl)
                logits.append((lg.float(), fed))
            runs.append(([x for x, _ in logits], [f for _, f in logits],
                         dict(build.LAUNCHES)))
    (got, _, launches), (want, _, plain) = runs
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item()
    assert not plain
    assert launches == {"fused_attention_masked": 1,
                        "fused_decode_block": 4}


def _moe_layer(dev, **over):
    """phi3.5-moe at full width cut to one layer, bf16 random weights
    from seed 0 on ``dev``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.weights import init_params
    cfg = dataclasses.replace(configs.get_config("phi3.5-moe-42b-a6.6b"),
                              n_layers=1, **over)
    g = torch.Generator(device=dev).manual_seed(0)
    return cfg, init_params(cfg, g, dev)


@pytest.mark.cuda
def test_moe_layer_gradients_are_bitwise_repeatable(cuda_device):
    """One phi3.5 layer (attention on #7-#9, the 16-expert MoE) at full
    width, bf16, B = 4, S = 256: two forward and backward passes give
    the same loss, aux losses and gradients bit for bit.  The dispatch
    permutes the token copies (unique indices), so no backward
    accumulates by atomics but the discarded sentinel row's."""
    from repro_torch import tree
    from repro_torch.train import step
    cfg, params = _moe_layer(cuda_device, remat="full")
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 257),
                                     generator=g, device=cuda_device)}
    runs = []
    for _ in range(2):
        build.reset_launches()
        (loss, m), grads = step.value_and_grad(params, cfg, batch)
        torch.cuda.synchronize()
        runs.append((loss, m, grads, dict(build.LAUNCHES)))
    (l1, m1, g1, n1), (l2, m2, g2, n2) = runs
    assert n1 == n2 == {"fused_attention_fwd": 2,
                        "fused_attention_bwd_dq": 1,
                        "fused_attention_bwd_dkv": 1}
    assert torch.equal(l1, l2)
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert torch.equal(m1[key], m2[key]) and m1[key].item() > 0
    router = g1["layers"][0]["moe"]["router"]
    assert router.dtype == torch.float32 and router.abs().max() > 0
    for a, b in zip(tree.leaves(g1), tree.leaves(g2)):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_zero_router_picks_the_first_experts_on_cuda(cuda_device):
    """Every token ties across the 16 experts: the port routes it to
    experts 0 and 1, as ``jax.lax.top_k`` does, on the card too."""
    from repro_torch.models import moe
    cfg, params = _moe_layer(cuda_device)
    lp = params["layers"][0]["moe"]
    lp = {k: v[0] for k, v in lp.items()}
    lp["router"] = torch.zeros_like(lp["router"])
    x = torch.randn(2, 64, cfg.d_model, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        y, _ = moe.moe_forward(lp, cfg, x)
        topi = moe.route(lp["router"], x, cfg.top_k)[3]
    assert (topi == torch.arange(cfg.top_k, device=cuda_device)).all()
    assert torch.isfinite(y.float()).all()
    _, idx = moe.top_k(torch.full((5, 16), 1 / 16, device=cuda_device), 2)
    assert idx.tolist() == [[0, 1]] * 5


@pytest.mark.cuda
def test_moe_layer_fp32_on_cuda_matches_the_cpu(cuda_device):
    """phi3.5's MoE FFN at full width (16 experts of 6400) in fp32
    compute, its bf16 weights cast, B = 2, S = 64: the card's output
    within 1e-4 of the CPU's, relative to the largest, and the same
    routing."""
    from repro_torch.models import moe
    cfg, params = _moe_layer(cuda_device, compute_dtype="float32")
    lp = {k: v[0] for k, v in params["layers"][0]["moe"].items()}
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 64, cfg.d_model, generator=g, device=cuda_device)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        on = {k: v.to(dev) for k, v in lp.items()}
        with torch.no_grad():
            y, aux = moe.moe_forward(on, cfg, x.to(dev))
            topi = moe.route(on["router"], x.to(dev), cfg.top_k)[3]
        outs.append((y.cpu(), {k: v.cpu() for k, v in aux.items()},
                     topi.cpu()))
    (y, aux, topi), (want, jaux, wtopi) = outs
    assert torch.equal(topi, wtopi)
    assert _rel(y, want) <= 1e-4
    for key in aux:
        assert abs(aux[key].item() - jaux[key].item()) <= \
            1e-5 * abs(jaux[key].item())


# ---------------------------------------------------------------------------
# #1's wide body: MLA's absorbed form (D 576, Dv 512, 128 heads over 1)
# ---------------------------------------------------------------------------

MLA_SCALE = 192 ** -0.5


def _latent(dev, dtype, b, sq, skv, hq=128, d=576, seed=0):
    """q (B, Hq, Sq, D) and the latent k (B, 1, Skv, D) from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hq, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, 1, skv, d, generator=g, device=dev).to(dtype)
    return q, k


def _rows_rel(got, want):
    """Each output row's max error over that row's largest |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return err / want.float().abs().amax(-1).clamp_min(1e-30)


#: (tag, B, Sq, Skv, lengths): decode past C = 2N = 1152 (the split into
#: KV chunks), a first and a second 1024-row prefill chunk (one pass)
WIDE_SHAPES = [("decode", 4, 1, 2048, [1153, 1400, 1800, 2048]),
               ("prefill_first", 1, 1024, 2048, [1024]),
               ("prefill_second", 1, 1024, 2048, [2048])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=[s[0] for s in WIDE_SHAPES])
def test_wide_masked_matches_plain_per_row(cuda_device, dtype, tol, shape):
    """The wide body at MLA's widths, V the first 512 columns of the
    latent K: every row within the dtype's tolerance of the plain
    version, bitwise repeatable, counted as #1's launch, in as many KV
    chunks as ``wide_chunks`` says."""
    from repro_torch.kernels.fused_attention import wide_chunks
    _, b, sq, skv, lens = shape
    q, k = _latent(cuda_device, dtype, b, sq, skv)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    build.reset_launches()
    got = fused_attention_masked(q, k, k[..., :512], lengths,
                                 scale=MLA_SCALE)
    assert build.LAUNCHES["fused_attention_masked"] == 1
    want = fused_attention_masked_plain(q, k, k[..., :512], lengths,
                                        scale=MLA_SCALE)
    assert got.shape == (b, 128, sq, 512)
    assert torch.isfinite(got.float()).all()
    assert _rows_rel(got, want).max().item() <= tol
    assert torch.equal(fused_attention_masked(q, k, k[..., :512], lengths,
                                              scale=MLA_SCALE), got)
    n = wide_chunks(b, 128, 1, sq, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count, dtype)
    assert (n > 1) == (sq == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_wide_masked_edges(cuda_device, dtype, tol):
    """Lengths 0, 1 and on either side of the 32-key tile, a group of 8
    over Sq = 5 (a block's rows span query heads under the causal
    anchor), non-causal, and narrower heads past 128 (D 192 and Dv 130,
    D 250 and Dv 250): per row within tolerance; a length-0 row is 0."""
    cases = [(8, 1, 96, [0, 1, 31, 33], 576, 512, True),
             (8, 5, 300, [70, 5], 576, 512, True),
             (8, 3, 100, [64, 32], 576, 512, False),
             (16, 2, 80, [80, 41], 192, 130, True),
             (4, 4, 70, [65, 9], 250, 250, True)]
    for hq, sq, skv, lens, d, dv, causal in cases:
        q, k = _latent(cuda_device, dtype, len(lens), sq, skv, hq, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        got = fused_attention_masked(q, k, k[..., :dv], lengths,
                                     causal=causal, scale=MLA_SCALE)
        want = fused_attention_masked_plain(q, k, k[..., :dv], lengths,
                                            causal=causal, scale=MLA_SCALE)
        live = want.float().abs().amax(-1) > 0
        assert (got.float()[~live] == 0).all()
        assert _rows_rel(got, want)[live].max().item() <= tol, (hq, sq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_masked_row_gate_rejects_a_dropped_tile(cuda_device, dtype):
    """The per-row gate the wide body passes rejects, for every batch
    row at the decode shape, the plain result without that row's last
    32 keys (a tile's worth of the wide body)."""
    from repro_torch.kernels.fused_attention import WIDE_TILE
    q, k = _latent(cuda_device, dtype, 4, 1, 2048)
    lens = [1153, 1400, 1800, 2048]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = fused_attention_masked(q, k, k[..., :512], lengths,
                                 scale=MLA_SCALE)
    short = torch.tensor([n - WIDE_TILE for n in lens],
                         dtype=torch.int32, device=cuda_device)
    cut = fused_attention_masked_plain(q, k, k[..., :512], short,
                                       causal=False, scale=MLA_SCALE)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (_rows_rel(cut, got).amax(1) > tol).all()


@pytest.mark.cuda
def test_wide_masked_refuses_what_it_cannot_take(cuda_device):
    """D 578 or Dv 514, a V that is not K's column prefix, and the
    training forward (#7) past MLA's cache-free widths (D 200 over Dv
    128) raise; nothing falls back."""
    q, k = _latent(cuda_device, torch.bfloat16, 1, 1, 64, 8, 578)
    lengths = torch.tensor([64], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head widths"):
        fused_attention_masked(q, k, k[..., :512], lengths)
    q, k = _latent(cuda_device, torch.bfloat16, 1, 1, 64, 8, 576)
    k2 = torch.cat([k, k[..., :2]], dim=-1)
    with pytest.raises(ValueError, match="head widths"):
        fused_attention_masked(q, k, k2[..., :514], lengths)
    with pytest.raises(ValueError, match="column"):
        fused_attention_masked(q, k, k[..., :512].contiguous(), lengths)
    qf, kf = _latent(cuda_device, torch.bfloat16, 1, 16, 16, 4, 200)
    with pytest.raises(ValueError, match="at most 192"):
        fused_attention_fwd(qf, kf, kf[..., :128].contiguous())


@pytest.mark.cuda
def test_wide_body_runs_on_the_tensor_cores(cuda_device):
    """The wide body's bf16 kernel has HMMA in its SASS, its fp32 one
    none (FMAs)."""
    for name, (mma_symbol, fma_symbol) in build.WIDE_BODIES.items():
        build.build_all([name])
        assert build.sass_hmma(name, mma_symbol) > 0
        assert build.sass_hmma(name, fma_symbol) == 0


# ---------------------------------------------------------------------------
# MLA training: #7-#9's *_mma_kernel_d192 instantiations (bf16) and the
# FMA bodies sized for 192 (fp32)
# ---------------------------------------------------------------------------

#: b, hq, hkv, sq, skv, d, dv, causal, q_offset: MLA's cache-free heads
#: (D = nope 128 + rope 64, Dv 128, group 1) off the 64-row and 64-key
#: tiles; non-causal over a group of 2; and widths inside (128, 192] that
#: the instantiation zero-pads in its fragments: D 160 over Dv 96 with
#: Sq < Skv, D 130 over Dv 66 (not multiples of 8: plain loads) under an
#: explicit causal offset
MLA_TRAIN_CASES = [(2, 8, 8, 300, 300, 192, 128, True, None),
                   (1, 4, 2, 200, 200, 192, 128, False, None),
                   (1, 4, 4, 72, 160, 160, 96, True, None),
                   (1, 2, 1, 64, 160, 130, 66, True, 30)]


def _per_row(got, want):
    """Each row's max |got - want| over the row's largest |want|, the
    largest over the rows; a row whose |want| stays below 1e-3 of the
    tensor's largest (dq's causal row 0, exactly 0 in exact arithmetic;
    a row that sees no key) is held against the tensor's largest."""
    got, want = got.float(), want.float()
    top = want.abs().max()
    scale = want.abs().amax(-1)
    scale = torch.where(scale > 1e-3 * top, scale, top.clamp_min(1e-30))
    return ((got - want).abs().amax(-1) / scale).max().item()


def _train_outputs(q, k, v, do, plain=False, **kw):
    """(o, lse, dq, dk, dv): #7, then #8 and #9 on the plain forward's
    lse and delta, or (``plain``) their plain versions."""
    o_p, lse_p = fused_attention_fwd_plain(q, k, v, **kw)
    delta = ref.attention_delta(o_p, do)
    a = (q, k, v, do, lse_p, delta)
    if plain:
        return (o_p, lse_p, fused_attention_bwd_dq_plain(*a, **kw),
                *fused_attention_bwd_dkv_plain(*a, **kw))
    return (*fused_attention_fwd(q, k, v, **kw),
            fused_attention_bwd_dq(*a, **kw),
            *fused_attention_bwd_dkv(*a, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,q_offset",
                         MLA_TRAIN_CASES)
def test_mla_training_widths_match_plain_per_row(cuda_device, dtype, tol, b,
                                                 hq, hkv, sq, skv, d, dv,
                                                 causal, q_offset):
    """o, dq, dk and dv per row within tol of the plain versions, lse
    within 1e-3 (bf16) or 1e-4 (fp32) absolute; one launch each; the
    five outputs bitwise repeatable."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda_device).to(dtype)
    q, k, v, do = r(b, hq, sq, d), r(b, hkv, skv, d), r(b, hkv, skv, dv), \
        r(b, hq, sq, dv)
    kw = dict(causal=causal, q_offset=q_offset)
    build.reset_launches()
    got = _train_outputs(q, k, v, do, **kw)
    assert dict(build.LAUNCHES) == {"fused_attention_fwd": 1,
                                    "fused_attention_bwd_dq": 1,
                                    "fused_attention_bwd_dkv": 1}
    want = _train_outputs(q, k, v, do, plain=True, **kw)
    for name, a, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a.float()).all(), name
        if name == "lse":
            lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
            assert (a - w).abs().max().item() <= lse_tol
        else:
            assert _per_row(a, w) <= tol, name
    again = _train_outputs(q, k, v, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_mla_training_row_gate_rejects_a_dropped_tile(cuda_device, dtype,
                                                      tol):
    """At MLA's widths the per-row gate the kernels pass rejects the
    plain results with one tile of work dropped: o with the last 64
    rows' last 64 keys left out (a key tile of #7's walk), dk and dv
    with the last 64 query rows left out (a query tile of #9's walk)."""
    b, h, s, d, dv = 1, 4, 256, 192, 128
    g = torch.Generator(device=cuda_device).manual_seed(4)
    r = lambda *sh: torch.randn(*sh, generator=g,
                                device=cuda_device).to(dtype)
    q, k, v, do = r(b, h, s, d), r(b, h, s, d), r(b, h, s, dv), \
        r(b, h, s, dv)
    o, _, _, dk, dvv = _train_outputs(q, k, v, do)
    o_p, lse_p, _, dk_p, dv_p = _train_outputs(q, k, v, do, plain=True)
    assert max(_per_row(o, o_p), _per_row(dk, dk_p),
               _per_row(dvv, dv_p)) <= tol
    t = 64
    o_m = o_p.clone()
    o_m[:, :, -t:] = fused_attention_fwd_plain(
        q[:, :, -t:], k[:, :, :-t], v[:, :, :-t], q_offset=s - t)[0]
    assert _per_row(o_m, o_p) > tol
    delta = ref.attention_delta(o_p, do)
    dk_m, dv_m = fused_attention_bwd_dkv_plain(
        q[:, :, :-t], k, v, do[:, :, :-t], lse_p[:, :, :-t],
        delta[:, :, :-t], q_offset=0)
    assert _per_row(dk_m, dk_p) > tol and _per_row(dv_m, dv_p) > tol


@pytest.mark.cuda
def test_training_attention_refuses_past_mla_widths(cuda_device):
    """D 200 over Dv 128 and D 192 over Dv 136: #7, #8 and #9 raise in
    their wrappers, and their C entry points refuse the widths too
    (the launch raises, nothing is counted); nothing falls back."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    bf = torch.bfloat16
    for d, dv, most in ((200, 128, 192), (192, 136, 128)):
        q, k = (torch.randn(1, 2, 64, d, generator=g, device=cuda_device)
                .to(bf) for _ in range(2))
        v, do = (torch.randn(1, 2, 64, dv, generator=g,
                             device=cuda_device).to(bf) for _ in range(2))
        lse = torch.zeros(1, 2, 64, device=cuda_device)
        for call in (lambda: fused_attention_fwd(q, k, v),
                     lambda: fused_attention_bwd_dq(q, k, v, do, lse, lse),
                     lambda: fused_attention_bwd_dkv(q, k, v, do, lse, lse)):
            with pytest.raises(ValueError, match=f"at most {most}"):
                call()
        build.reset_launches()
        with pytest.raises(RuntimeError, match="launch failed"):
            build.launch("fused_attention_fwd", q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(), 1, 2, 2,
                         64, 64, d, dv, 1, 0, d ** -0.5, build.dtype_code(q))
        assert not build.LAUNCHES


@pytest.mark.cuda
def test_mla_layers_train_on_the_d192_kernels(cuda_device):
    """deepseek-v3's dense-layer form (MLA, no MoE, no prefix) at its
    head widths (8 heads of D = 128 + 64, Dv = 128) with a narrow model
    (d_model 1024), 2 layers, bf16, remat full: the loss and every
    gradient of one 2 x 300 token batch on the kernels against the plain
    versions (loss within 1e-2 relative, each leaf within 2e-2 of its
    largest); #7 twice a layer (the recompute), #8 and #9 once; the
    gradients bitwise repeatable."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.models.weights import init_params
    from repro_torch.train import step
    cfg = dataclasses.replace(
        configs.get_config("deepseek-v3-671b"), n_layers=2,
        first_dense_layers=0, moe=False, d_model=1024, n_heads=8,
        n_kv_heads=8, q_lora_rank=256, kv_lora_rank=128, d_ff=2048,
        vocab_size=1024)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, g, cuda_device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 301),
                                     generator=g, device=cuda_device)}
    build.reset_launches()
    (loss, _), grads = step.value_and_grad(params, cfg, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {
        "fused_attention_fwd": 2 * cfg.n_layers,
        "fused_attention_bwd_dq": cfg.n_layers,
        "fused_attention_bwd_dkv": cfg.n_layers}
    _, again = step.value_and_grad(params, cfg, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(grads),
                                                 tree.leaves(again)))
    build.reset_launches()
    (want, _), plain = step.value_and_grad(params, cfg, batch, impl="torch")
    assert not build.LAUNCHES
    assert abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())
    for a, b in zip(tree.leaves(grads), tree.leaves(plain)):
        assert torch.isfinite(a.float()).all() and a.abs().max() > 0
        assert _rel(a, b) <= 2e-2


@pytest.mark.cuda
def test_head_parallel_decode_on_two_ranks_sharing_the_card(cuda_device,
                                                            tmp_path):
    """``head_parallel_decode_attention`` and the sequence-sharded combine
    on two gloo ranks that share ``cuda:0`` (their collectives staged
    through host memory) against the plain single-rank attention and
    output projection on the card, fp32 at starcoder2-7b's widths (36
    query heads over 4 of 128) with mixed lengths, one past every
    column of the second rank's half."""
    from repro_torch.launch import mesh_ranks
    from repro_torch.launch.mesh import spawn
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, hq, hkv, c, d, e = 4, 36, 4, 256, 128, 512
    q = torch.randn(b, hq, 1, d, generator=g, device=cuda_device)
    k = torch.randn(b, hkv, c, d, generator=g, device=cuda_device)
    v = torch.randn(b, hkv, c, d, generator=g, device=cuda_device)
    wo = torch.randn(hq, d, e, generator=g, device=cuda_device) * 0.05
    lengths = torch.tensor([256, 100, 1, 129], dtype=torch.int32,
                           device=cuda_device)
    out = spawn(2, mesh_ranks.decode_attention, backend="gloo",
                devices=["cuda:0", "cuda:0"],
                init_file=str(tmp_path / "init"),
                args=((1, 2), q.cpu(), k.cpu(), v.cpu(), lengths.cpu(),
                      wo.cpu()), timeout=300)
    o = ref.attention_reference(q, k, v, causal=False, lengths=lengths)
    want = torch.einsum("bhse,hed->bsd", o, wo)
    for rank in range(2):
        assert _rel(out[rank]["hp"].to(cuda_device), want) <= 1e-5
        assert _rel(out[rank]["dist"].to(cuda_device), o) <= 1e-5


def kernel_calls(dev, dtype=torch.float32) -> list:
    """One small call of each of the eleven kernel wrappers on ``dev``:
    (kernel name, module holding its wrapper and plain version, wrapper
    name, plain version name, args, kwargs, cost arguments, cost
    keywords) with the inputs on ``dev`` (values valid on the card: the
    lengths within the cache, the tables' pages within the pools).  The
    cost arguments count every cache column valid and every table entry
    read, as the wrappers report them."""
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import fused_decode_block as fdb
    from repro_torch.kernels import fused_qproj_attention as fqa
    from repro_torch.kernels import ssd_scan as ss

    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32).to(dev)

    b, hq, hkv, sq, skv, d, e, page = 2, 4, 2, 3, 24, 16, 32, 8
    el = torch.empty((), dtype=dtype).element_size()
    q, k, v = r(b, hq, sq, d), r(b, hkv, skv, d), r(b, hkv, skv, d)
    lens, tbl = i32([24, 17]), i32([[1, 2, 3], [4, 5, 0]])
    kp, vp = r(7, hkv, page, d), r(7, hkv, page, d)
    x, x1 = r(b, sq, e), r(b, 1, e)
    wq, wo = r(e, hq, d, scale=e ** -0.5), r(hq, d, e, scale=0.1)
    res, q1 = r(b, 1, e), r(b, hq, 1, d)
    qt, do = r(b, hq, skv, d), r(b, hq, skv, d)
    lse = torch.randn(b, hq, skv, generator=g).to(dev)
    delta = torch.randn(b, hq, skv, generator=g).to(dev)
    xt = r(b, skv, e)
    hs, ps, gs, ss_, ln, ch = 4, 8, 2, 8, 40, 16
    ssd_args = (r(b, ln, hs, ps), r(b, ln, hs).abs() * 0.1,
                -torch.rand(hs, generator=g).to(dev), r(b, ln, gs, ss_),
                r(b, ln, gs, ss_), r(hs))
    att = (b, hq, hkv, skv, skv, d, d)
    return [
        ("fused_attention_masked", fa, "fused_attention_masked",
         "fused_attention_masked_plain", (q, k, v, lens), {},
         (b, hq, hkv, sq, skv, d, d), dict(el=el)),
        ("fused_qproj_attention_masked", fqa, "fused_qproj_attention_masked",
         "fused_qproj_attention_masked_plain", (x, wq, k, v, lens),
         dict(rope_theta=1e4), (b, sq, e, hq, hkv, skv, d, d), dict(el=el)),
        ("fused_decode_block", fdb, "fused_decode_block",
         "fused_decode_block_plain", (x1, wq, k, v, wo, res, lens),
         dict(rope_theta=1e4), (b, e, hq, hkv, skv, d, d), dict(el=el)),
        ("fused_attention_paged", fa, "fused_attention_paged",
         "fused_attention_paged_plain", (q1, kp, vp, lens, tbl), {},
         (b, hq, hkv, 1, skv, d, d), dict(el=el, table=6)),
        ("fused_qproj_attention_paged", fqa, "fused_qproj_attention_paged",
         "fused_qproj_attention_paged_plain", (x1, wq, kp, vp, lens, tbl),
         dict(rope_theta=1e4), (b, 1, e, hq, hkv, skv, d, d),
         dict(el=el, table=6)),
        ("fused_decode_block_paged", fdb, "fused_decode_block_paged",
         "fused_decode_block_paged_plain",
         (x1, wq, kp, vp, wo, res, lens, tbl), dict(rope_theta=1e4),
         (b, e, hq, hkv, skv, d, d), dict(el=el, table=6)),
        ("fused_attention_fwd", fa, "fused_attention_fwd",
         "fused_attention_fwd_plain", (qt, k, v), {}, att, dict(el=el)),
        ("fused_attention_bwd_dq", fa, "fused_attention_bwd_dq",
         "fused_attention_bwd_dq_plain", (qt, k, v, do, lse, delta), {},
         att, dict(el=el)),
        ("fused_attention_bwd_dkv", fa, "fused_attention_bwd_dkv",
         "fused_attention_bwd_dkv_plain", (qt, k, v, do, lse, delta), {},
         att, dict(el=el)),
        ("fused_qproj_attention_fwd", fqa, "fused_qproj_attention_fwd",
         "fused_qproj_attention_fwd_plain", (xt, wq, k, v),
         dict(rope_theta=1e4), (b, skv, e, hq, hkv, skv, d, d),
         dict(el=el)),
        ("ssd_scan", ss, "ssd_scan", "ssd_scan_plain", ssd_args,
         dict(chunk=ch), (b, ln, hs, ps, gs, ss_, ch), dict(el=el)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(11))
def test_cuda_tensors_never_take_a_plain_version(cuda_device, monkeypatch,
                                                 i):
    """Each wrapper on CUDA tensors launches its kernel once, with its
    plain version made to raise, and reports its closed-form cost
    (``kernels/cost.py``) to an active counter, every cache column
    counted valid."""
    from repro_torch.kernels import cost
    from repro_torch.launch import cost_analysis

    name, mod, wrapper, plain, args, kw, shapes, skw = kernel_calls(
        cuda_device)[i]

    def refuse(*a, **k):
        raise AssertionError(f"{plain} ran on a CUDA tensor")

    monkeypatch.setattr(mod, plain, refuse)
    before = build.LAUNCHES[name]
    with torch.no_grad(), cost_analysis.count() as c:
        getattr(mod, wrapper)(*args, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    flops, nbytes = cost.cost(name, *shapes, **skw)
    got = c.result()
    assert (got["flops"], got["bytes_accessed"]) == (flops, nbytes)
    assert got["kernels"] == {name: 1}
