"""The port's kernels against the JAX package's Pallas kernels.

On the CPU: each kernel's plain PyTorch version (what its wrapper runs
for a CPU tensor) against the Pallas kernel in interpret mode, on the
same numpy inputs, fp32, atol 1e-5 -- GQA with a group of 3, a length
of 0, lengths off the block grid, Sq > 1 under the causal anchor, RoPE
on and off.  Also the dispatch in ``kernels.ops``: impls, refusals and
counts.  The CUDA kernels themselves are held to these plain versions
on the card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import xla_fallback as jax_xla
from repro.kernels.fused_attention import (
    fused_attention_masked as pallas_attention_masked)
from repro.kernels.fused_decode_block import (
    fused_decode_block as pallas_decode_block)
from repro.kernels.fused_qproj_attention import (
    fused_qproj_attention_masked as pallas_qproj_masked)

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.fused_attention import fused_attention_masked
from repro_torch.kernels.fused_decode_block import fused_decode_block
from repro_torch.kernels.fused_qproj_attention import (
    fused_qproj_attention_masked)

torch.set_num_threads(2)

ATOL = 1e-5     # fp32: the two sum in different orders, nothing rounds


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# b, hq, hkv, sq, skv, d, causal, lengths
ATTN_CASES = [
    (3, 6, 2, 1, 160, 32, False, [100, 160, 0]),    # GQA 3, a length 0
    (2, 6, 2, 1, 150, 32, True, [77, 131]),         # ragged decode rows
    (2, 6, 2, 5, 192, 32, True, [70, 192]),         # Sq > 1, causal anchor
    (2, 4, 4, 3, 128, 64, True, [3, 0]),            # MHA, anchored at 0
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,lengths", ATTN_CASES)
def test_attention_plain_matches_pallas(b, hq, hkv, sq, skv, d, causal,
                                        lengths):
    rng = np.random.default_rng(0)
    q, jq = _both(_rand(rng, b, hq, sq, d))
    k, jk = _both(_rand(rng, b, hkv, skv, d))
    v, jv = _both(_rand(rng, b, hkv, skv, d))
    lens = np.array(lengths, np.int32)
    want = pallas_attention_masked(jq, jk, jv, jnp.asarray(lens),
                                   causal=causal, block_q=128, block_k=64,
                                   interpret=True)
    got = fused_attention_masked(q, k, v, torch.from_numpy(lens),
                                 causal=causal)
    _close(got, want)


# b, hq, hkv, sq, skv, e, d, lengths, rope
QPROJ_CASES = [
    (2, 6, 2, 1, 160, 48, 32, [100, 0], 1e4),
    (2, 6, 2, 4, 150, 48, 32, [4, 131], 1e4),
    (2, 6, 2, 7, 192, 64, 32, [70, 192], None),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,e,d,lengths,rope", QPROJ_CASES)
def test_qproj_plain_matches_pallas(b, hq, hkv, sq, skv, e, d, lengths,
                                    rope):
    rng = np.random.default_rng(1)
    x, jx = _both(_rand(rng, b, sq, e))
    wq, jwq = _both(_rand(rng, e, hq, d, scale=e ** -0.5))
    k, jk = _both(_rand(rng, b, hkv, skv, d))
    v, jv = _both(_rand(rng, b, hkv, skv, d))
    lens = np.array(lengths, np.int32)
    want = pallas_qproj_masked(jx, jwq, jk, jv, jnp.asarray(lens),
                               causal=True, rope_theta=rope, block_q=128,
                               block_k=64, interpret=True)
    got = fused_qproj_attention_masked(x, wq, k, v, torch.from_numpy(lens),
                                       causal=True, rope_theta=rope)
    _close(got, want)


# b, hq, hkv, skv, e, d, lengths, rope
DECODE_CASES = [
    (3, 6, 2, 160, 48, 32, [100, 0, 160], 1e4),
    (2, 6, 2, 130, 64, 32, [1, 129], None),
]


@pytest.mark.parametrize("b,hq,hkv,skv,e,d,lengths,rope", DECODE_CASES)
def test_decode_block_plain_matches_pallas(b, hq, hkv, skv, e, d, lengths,
                                           rope):
    rng = np.random.default_rng(2)
    x, jx = _both(_rand(rng, b, 1, e))
    res, jres = _both(_rand(rng, b, 1, e))
    wq, jwq = _both(_rand(rng, e, hq, d, scale=e ** -0.5))
    wo, jwo = _both(_rand(rng, hq, d, e, scale=(hq * d) ** -0.5))
    k, jk = _both(_rand(rng, b, hkv, skv, d))
    v, jv = _both(_rand(rng, b, hkv, skv, d))
    lens = np.array(lengths, np.int32)
    want = pallas_decode_block(jx, jwq, jk, jv, jwo, jres,
                               jnp.asarray(lens), rope_theta=rope,
                               block_k=64, interpret=True)
    got = fused_decode_block(x, wq, k, v, wo, res, torch.from_numpy(lens),
                             rope_theta=rope)
    _close(got, want)
    # a length-0 row returns its residual exactly
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], res[i])


@pytest.mark.parametrize("causal,q_offset", [(True, None), (True, 30),
                                             (False, None)])
def test_chunked_matches_jax_fallback(causal, q_offset):
    """The shared body against ``xla_fallback.chunked_attention`` with
    a scalar offset and lengths, across several q and kv blocks."""
    rng = np.random.default_rng(3)
    q, jq = _both(_rand(rng, 2, 6, 9, 16))
    k, jk = _both(_rand(rng, 2, 2, 40, 16))
    v, jv = _both(_rand(rng, 2, 2, 40, 16))
    lens = np.array([25, 40], np.int32)
    want = jax_xla.chunked_attention(jq, jk, jv, causal=causal,
                                     q_offset=q_offset,
                                     lengths=jnp.asarray(lens), block_q=4,
                                     block_k=16)
    got = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                            lengths=torch.from_numpy(lens), block_q=4,
                            block_k=16)
    _close(got, want)


def test_ops_impls_agree_and_count():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_rand(rng, 2, 6, 3, 32))
    k = torch.from_numpy(_rand(rng, 2, 2, 64, 32))
    v = torch.from_numpy(_rand(rng, 2, 2, 64, 32))
    lens = torch.tensor([20, 20], dtype=torch.int32)
    ops.reset_counts()
    outs = [ops.attention(q, k, v, q_offset=17, lengths=lens, impl=impl)
            for impl in ("auto", "torch", "reference")]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=ATOL)
    # a plan-less auto call resolves the shape-only plan: 3 rows over a
    # 64-deep cache at N = 32 sit at C = 2N, where the plan is unfused
    from repro_torch import lower
    assert lower.kernel_plan(seq_q=3, seq_kv=64, d_head=32, n_heads=6,
                             n_kv_heads=2).kernel_path == lower.UNFUSED
    assert ops.CALLS[("attention", "torch")] == 1
    assert ops.CALLS[("attention", "reference")] == 2
    assert not build.LAUNCHES      # the CPU never launches a kernel


def test_ops_refuses_inconsistent_offset_onto_reference():
    """An explicit causal offset the masked kernels cannot express runs
    the reference, with the reason recorded on the plan."""
    from repro_torch import configs, lower
    cfg = configs.get_config("qwen3-8b", smoke=True)
    d = lower.serving_plan(cfg, 256, device="cpu").decode_dispatch(200)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_rand(rng, 2, 4, 3, 32))
    k = torch.from_numpy(_rand(rng, 2, 2, 64, 32))
    v = torch.from_numpy(_rand(rng, 2, 2, 64, 32))
    lens = torch.tensor([20, 30], dtype=torch.int32)
    ops.reset_downgrade_warnings()
    with pytest.warns(UserWarning, match="inconsistent"):
        got = ops.attention(q, k, v, q_offset=17, lengths=lens, plan=d)
    want = ref.attention_reference(q, k, v, causal=True, q_offset=17,
                                   lengths=lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any("inconsistent" in g.reason for g in d.plan.downgrades)


def test_ops_head_width_is_no_refusal():
    """A head wider than the CUDA kernels take is the wrapper's limit,
    not a reason to run the reference: on the CPU the plan's fused path
    runs its plain version and records nothing."""
    from repro_torch import configs, lower
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    d = lower.serving_plan(cfg, 256, device="cpu").prefill_dispatch(200)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_rand(rng, 1, 4, 5, 256))
    k = torch.from_numpy(_rand(rng, 1, 2, 16, 256))
    v = torch.from_numpy(_rand(rng, 1, 2, 16, 256))
    lens = torch.tensor([9], dtype=torch.int32)
    ops.reset_counts()
    got = ops.attention(q, k, v, q_offset=4, lengths=lens, plan=d)
    want = ref.attention_reference(q, k, v, causal=True, q_offset=4,
                                   lengths=lens)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert d.impl == "torch" and ops.CALLS[("attention", "torch")] == 1
    assert not d.plan.downgrades


def test_kernel_wrappers_refuse_bad_cuda_args():
    """The CUDA-side argument checks run without a card: a mixed-device
    call is refused before any launch."""
    q = torch.zeros(1, 2, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.fused_attention import check_cuda_args
        check_cuda_args("k", {"q": q}, torch.zeros(1, dtype=torch.int32),
                        (8,))


# (B, Hq, Hkv, Sq): qwen3-8b decode at B=4 and B=2, a causal 5-row chunk
SPLIT_SHAPES = [(4, 32, 8, 1), (2, 32, 8, 1), (3, 32, 8, 5)]


@pytest.mark.parametrize("b,hq,hkv,sq", SPLIT_SHAPES)
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 301, 705, 1023, 4096])
def test_split_plan_covers_the_prefix_in_whole_tiles(b, hq, hkv, sq, length):
    """The split-KV decode body's plan (``csrc/fused_attention.cu``
    ``split_kernel``, mirrored by ``split_chunks`` and ``chunk_bounds``):
    at most n_chunks chunks cover [0, length) exactly, in order, each
    starting on a 64-key tile and ending on one or at ``length``; a
    length-0 row has none.  The one-pass grid here has fewer blocks than
    an H100's 132 SMs, so the split body is taken."""
    from repro_torch.kernels.fused_attention import (TILE, chunk_bounds,
                                                     split_chunks)
    n = split_chunks(b, hq, hkv, sq, 132)
    assert n > 0
    bounds = chunk_bounds(length, n)
    assert len(bounds) <= n
    if length == 0:
        assert bounds == []
        return
    assert bounds[0][0] == 0 and bounds[-1][1] == length
    for (s0, e0), (s1, _) in zip(bounds, bounds[1:]):
        assert e0 == s1
    for s0, e0 in bounds:
        assert s0 % TILE == 0 and s0 < e0
        assert e0 % TILE == 0 or e0 == length
    # a grid that fills the card keeps the one-pass body: a 256-row
    # prefill chunk of starcoder2-7b's heads
    assert split_chunks(1, 36, 4, 256, 132) == 0


@pytest.mark.parametrize("skv,page,n_pages", [(1024, 16, 300), (200, 8, 51),
                                              (256, 128, 9)])
def test_split_plan_is_the_same_for_dense_and_paged(skv, page, n_pages):
    """The masked kernel on a dense cache and the paged kernel on a pool
    of another capacity take the same chunk count (read from q and the
    V array's KV heads alone), so over the gathered cache they split
    every row alike and give the same output bit for bit."""
    from repro_torch.kernels.fused_attention import chunk_bounds, kv_split
    for b, hq, hkv, sq in SPLIT_SHAPES:
        q = torch.zeros(b, hq, sq, 128)
        dense = torch.zeros(b, hkv, skv, 128)
        pool = torch.zeros(n_pages, hkv, page, 128)
        n = kv_split(q, dense, 132)
        assert n == kv_split(q, pool, 132) > 0
        for length in range(0, min(skv, n_pages * page) + 1, 37):
            assert chunk_bounds(length, n) == chunk_bounds(
                length, kv_split(q, pool, 132))


# (B, Hq, Hkv, Sq): the table shape of #1 (starcoder2-7b's 256-row
# prefill chunk), its short last chunks (40 and 64 rows), a 128-row
# chunk, qwen3-8b decode and a causal 5-row chunk
GRID_SHAPES = [(1, 36, 4, 256), (1, 36, 4, 40), (1, 36, 4, 64),
               (1, 36, 4, 128), (4, 32, 8, 1), (3, 32, 8, 5)]


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 64),
                                        (torch.float32, 16)])
@pytest.mark.parametrize("b,hq,hkv,sq", GRID_SHAPES)
def test_split_rule_reads_the_grid_that_would_launch(dtype, rows, b, hq, hkv,
                                                     sq):
    """``one_pass_blocks`` counts the grid of the one-pass body that runs
    in each dtype (``csrc/masked_mma.cuh``'s 64-row tiles in bf16,
    ``common.cuh``'s 16-row FMA tiles in fp32), and ``split_chunks``
    takes the split-KV body exactly when that grid has fewer blocks than
    the card's SMs and the split's own 16-row tiles get at least two
    chunks each."""
    from repro_torch.kernels.fused_attention import (
        ROWS, one_pass_blocks, one_pass_rows, split_chunks)
    assert one_pass_rows(dtype) == rows
    grid = -(-(hq // hkv) * sq // rows) * b * hkv
    assert one_pass_blocks(b, hq, hkv, sq, one_pass_rows(dtype)) == grid
    split_tiles = one_pass_blocks(b, hq, hkv, sq)
    assert split_tiles == -(-(hq // hkv) * sq // ROWS) * b * hkv
    for n_sms in (132, 114):
        n = split_chunks(b, hq, hkv, sq, n_sms, dtype)
        if grid >= n_sms or 2 * n_sms // split_tiles < 2:
            assert n == 0
        else:
            assert n == 2 * n_sms // split_tiles >= 2
            # one wave: at most two split blocks per SM
            assert n * split_tiles <= 2 * n_sms
    # the table shape keeps the one-pass body in both dtypes
    assert split_chunks(1, 36, 4, 256, 132, dtype) == 0


def test_split_rule_cases_by_dtype():
    """Where the two one-pass grids fall on either side of the SM count:
    a 128-row chunk of starcoder2-7b is 72 blocks at 64 rows but 288 at
    16, and the split would give it one chunk, so both dtypes run the
    one-pass body; a 40-row chunk (92 split tiles) splits in two in both;
    qwen3-8b decode splits into 8 chunks in both."""
    from repro_torch.kernels.fused_attention import split_chunks
    for dtype in (torch.bfloat16, torch.float32):
        assert split_chunks(1, 36, 4, 128, 132, dtype) == 0
        assert split_chunks(1, 36, 4, 40, 132, dtype) == 2
        assert split_chunks(4, 32, 8, 1, 132, dtype) == 8
    # a 64-row chunk: 36 bf16 blocks, 144 fp32 blocks, the split one chunk
    assert split_chunks(1, 36, 4, 64, 132, torch.bfloat16) == 0
    assert split_chunks(1, 36, 4, 64, 132, torch.float32) == 0
    # 8 rows of a group of 4 on 8 KV heads, B=2: 16 bf16 blocks, 32 split
    # tiles, so 8 chunks; fp32's grid is the split's tiles, 32 < 132
    assert split_chunks(2, 32, 8, 8, 132, torch.bfloat16) == 8
    assert split_chunks(2, 32, 8, 8, 132, torch.float32) == 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_plan_is_the_same_for_dense_and_paged_in_each_dtype(dtype):
    """``kv_split`` reads q's dtype and shapes and the V array's KV heads,
    all of which a dense call and its paged twin share: over every shape
    of SPLIT_SHAPES and GRID_SHAPES the two plans agree in each dtype."""
    from repro_torch.kernels.fused_attention import kv_split
    for b, hq, hkv, sq in SPLIT_SHAPES + GRID_SHAPES:
        q = torch.zeros(b, hq, sq, 128, dtype=dtype)
        dense = torch.zeros(b, hkv, 300, 128, dtype=dtype)
        for page, n_pages in ((8, 51), (16, 300), (128, 9)):
            pool = torch.zeros(n_pages, hkv, page, 128, dtype=dtype)
            assert kv_split(q, dense, 132) == kv_split(q, pool, 132)
