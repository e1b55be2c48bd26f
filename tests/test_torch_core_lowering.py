"""The port's schedule lowering (``repro_torch.lower``) against the JAX
package's (``repro.lower``): for every ported dense config and
phi3.5-moe (a GQA stack whose FFN is MoE), at smoke
width and at its full width with one and two blocks, prefill rows
across M = N and decode contexts across C = 2N at one and four decode
tokens, with the decision rule's choice and every forced flag
combination, the lowered plans carry equal fields and equal source
schedules.  Tiles are the card's own, so they are held to the kernel
modules' constants instead of to JAX's.  The engine predictions are in
tests/test_torch_core_predict.py."""

import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro import lower as jlower
from repro.kernels import ops as jops

from repro_torch import configs, lower
from repro_torch.core import codesign
from repro_torch.kernels import fused_attention as fa
from repro_torch.kernels import fused_decode_block as fdb
from repro_torch.kernels import ops

DENSE = ["starcoder2-7b", "qwen3-8b", "qwen3-14b", "starcoder2-15b",
         "phi3.5-moe-42b-a6.6b"]

#: (fuse_q, fuse_scores, fuse_block): the rule's choice, then forced
FLAGS = [(None, None, None), (False, False, None), (True, False, None),
         (False, True, None), (True, True, None), (True, True, True),
         (True, True, False)]


def _cells(phase: str, n: int):
    """(length, decode_tokens) of one phase at head width ``n``."""
    if phase == "prefill":
        return [(m, 1) for m in (32, 127, 128, 129, 512)]
    return [(c, t) for c in (2 * n - 1, 2 * n, 2 * n + 1, 4096)
            for t in (1, 4)]


def _fields(plan) -> dict:
    return {
        "config_name": plan.config_name, "phase": plan.phase, "M": plan.M,
        "score_cols": plan.score_cols, "head_dim": plan.head_dim,
        "n_blocks": plan.n_blocks, "bucket": plan.bucket,
        "alpha": plan.alpha, "crossover_ctx": plan.crossover_ctx,
        "kernel_path": plan.kernel_path,
        "blocks": [(b.block_index, b.phase, b.policy, b.kernel_path,
                    b.fuse_q, b.fuse_scores, b.fuse_block, b.streamed,
                    b.materialized) for b in plan.blocks],
        "schedule": dataclasses.asdict(plan.source.schedule),
        "workload": list(plan.source.workload.layers),
    }


def _configs(arch: str, smoke: bool):
    return (configs.get_config(arch, smoke=smoke),
            jconfigs.get_config(arch, smoke=smoke))


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("smoke,n_blocks", [(True, 1), (True, 2),
                                            (False, 1), (False, 2)])
@pytest.mark.parametrize("arch", DENSE)
def test_lowered_plans_equal_jax(arch, smoke, n_blocks, phase):
    cfg, jcfg = _configs(arch, smoke)
    for n, tokens in _cells(phase, cfg.head_dim):
        for fq, fs, fb in FLAGS:
            kw = dict(decode_tokens=tokens, n_blocks=n_blocks, bucket=n,
                      fuse_q=fq, fuse_scores=fs, fuse_block=fb)
            ours = lower.lower(cfg, phase, n, **kw)
            theirs = jlower.lower(jcfg, phase, n, **kw)
            assert _fields(ours) == _fields(theirs), (n, tokens, fq, fs, fb)
            assert len(ours.blocks) == n_blocks
            assert len({(b.kernel_path, b.tiling) for b in ours.blocks}) == 1


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", DENSE)
def test_cached_plans_equal_jax(arch, phase):
    """The plan cache resolves the same bucket's plan in both."""
    cfg, jcfg = _configs(arch, False)
    lower.clear_plan_cache()
    for n, tokens in _cells(phase, cfg.head_dim):
        ours = lower.resolve_plan(cfg, phase, n, decode_tokens=tokens,
                                  n_blocks=2)
        theirs = jlower.resolve_plan(jcfg, phase, n, decode_tokens=tokens,
                                     n_blocks=2)
        assert _fields(ours) == _fields(theirs)
        assert ours.source is not None and ours.blocks
    info = lower.plan_cache_info()
    assert info.misses == info.currsize and info.misses >= 1


@pytest.mark.parametrize("fq,fs", [(False, False), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("phase,n,tokens", [("prefill", 256, 1),
                                            ("decode", 512, 1)])
def test_fuse_block_without_both_flags_raises_like_jax(phase, n, tokens, fq,
                                                       fs):
    cfg, jcfg = _configs("starcoder2-7b", True)
    with pytest.raises(ValueError, match="fuse_block requires"):
        lower.lower(cfg, phase, n, decode_tokens=tokens, fuse_q=fq,
                    fuse_scores=fs, fuse_block=True)
    with pytest.raises(ValueError, match="fuse_block requires"):
        jlower.lower(jcfg, phase, n, decode_tokens=tokens, fuse_q=fq,
                     fuse_scores=fs, fuse_block=True)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_tiling_is_the_kernels_own(arch, dtype_bytes):
    """A plan's tiles are the ones the CUDA kernel for its path launches
    (the masked tensor-core body in bf16, its FMA body in fp32, the
    decode megakernel's attention items), and the fused working set at
    those tiles fits the H100's shared memory per block."""
    cfg, _ = _configs(arch, False)
    n = cfg.head_dim
    for path, want in (
            (lower.UNFUSED, (fa.MMA_ROWS if dtype_bytes == 2 else fa.ROWS,
                             fa.TILE)),
            (lower.FUSED_ATTENTION,
             (fa.MMA_ROWS if dtype_bytes == 2 else fa.ROWS, fa.TILE)),
            (lower.QPROJ_ATTENTION,
             (fa.MMA_ROWS if dtype_bytes == 2 else fa.ROWS, fa.TILE)),
            (lower.DECODE_MEGAKERNEL, (fdb.ROW_TILE, fdb.KEY_TILE))):
        t = codesign.plan_tiling("decode", 1, 4096, n, path=path,
                                 dtype_bytes=dtype_bytes)
        assert (t.block_q, t.block_kv) == want
        assert t.smem_budget_bytes == codesign.SMEM_PER_BLOCK_BYTES == 232448
        assert t.fits
    assert (fa.MMA_ROWS, fa.ROWS, fa.TILE) == (64, 16, 64)
    for phase, n_, tokens in (("prefill", 512, 1), ("decode", 4096, 1),
                              ("decode", 4096, 4), ("decode", 64, 1)):
        plan = lower.lower(cfg, phase, n_, decode_tokens=tokens)
        assert plan.tiling == codesign.plan_tiling(
            phase, plan.M, plan.score_cols, n, path=plan.kernel_path)
        d = lower.dispatch(plan, device="cpu")
        assert (d.block_q, d.block_k) == (plan.tiling.block_q,
                                          plan.tiling.block_kv)


def test_hbm_traffic_expressions_equal_jax():
    from repro.core import codesign as jcodesign
    for m, n in ((128, 128), (2048, 128), (64, 256)):
        assert codesign.hbm_traffic_unfused(m, n) == \
            jcodesign.hbm_traffic_unfused(m, n)
        assert codesign.hbm_traffic_fused(m, n) == \
            jcodesign.hbm_traffic_fused(m, n)
        assert codesign.fused_traffic_gain(m, n) == \
            jcodesign.fused_traffic_gain(m, n)
        assert codesign.fused_attention_working_set(64, 64, n) == \
            jcodesign.fused_attention_working_set(64, 64, n)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_supported_agrees_with_jax_on_every_arch(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    assert lower.supported(jcfg) == jlower.supported(jcfg)
    if arch in configs.ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        assert lower.supported(cfg) == jlower.supported(jcfg)
        plan = lower.serving_plan(cfg, 256, device="cpu")
        assert (plan is None) == (not jlower.supported(jcfg))
    if arch == "mamba2-130m":
        assert not lower.supported(jcfg)


#: (Sq, Skv, D, Hq, Hkv) of the plan-less ``impl="auto"`` calls the port's
#: tests make (tests/test_torch_kernels.py, tests/test_torch_paged.py,
#: the training tests at seq 96, 40 and 24, smoke decode), a group 5
#: and a group 12 call at the new configs' widths, and MLA's cache-free
#: training call (128 heads of D 192 over 128, S 2048)
AUTO_SHAPES = [(3, 64, 32, 6, 2), (1, 64, 32, 4, 2), (96, 96, 32, 4, 2),
               (40, 40, 32, 4, 2), (24, 24, 32, 4, 2), (1, 200, 32, 4, 2),
               (4, 300, 32, 4, 2), (2048, 2048, 128, 36, 4),
               (1, 4096, 128, 40, 8), (1, 200, 128, 48, 4),
               (300, 300, 128, 40, 8), (1, 257, 128, 48, 4),
               (2048, 2048, 192, 128, 128)]


@pytest.mark.parametrize("shape", AUTO_SHAPES)
def test_kernel_plan_equals_jax(shape):
    sq, skv, d, hq, hkv = shape
    kw = dict(seq_q=sq, seq_kv=skv, d_head=d, n_heads=hq, n_kv_heads=hkv)
    ours, theirs = lower.kernel_plan(**kw), jlower.kernel_plan(**kw)
    assert _fields(ours) == _fields(theirs)
    from repro.lower.cache import HeadConfig as JHeadConfig
    assert dataclasses.asdict(lower.head_config(d, hq, hkv)) == \
        dataclasses.asdict(JHeadConfig(
            name=f"head{hq}x{d}", d_model=hq * d, n_heads=hq,
            n_kv_heads=hkv if hq % hkv == 0 else 1, d_head=d,
            d_ff=4 * hq * d))
    for entry in ("attention", "qproj_attention", "decode_block"):
        for masked in (False, True):
            got = ops._auto_dispatch(entry, sq, skv, d, hq, hkv, masked,
                                     torch.device("cpu"))
            want = jops._auto_dispatch(entry, sq, skv, d, hq, hkv, masked,
                                       False)
            assert got.path == want.path
            assert got.impl == ("reference" if want.impl == "reference"
                                else "torch")


@pytest.mark.parametrize("m,n", [(4096, 128), (1, 128), (128, 128),
                                 (129, 128), (127, 128)])
def test_schedule_for_equals_jax(m, n):
    assert ops.schedule_for(m, n) == jops.schedule_for(m, n)


def test_plan_describe_and_predictions_without_the_engine():
    cfg, _ = _configs("starcoder2-7b", True)
    plan = lower.lower(cfg, "decode", 4096, n_blocks=2)
    text = plan.describe()
    assert text.count("block ") == 2 and "decode_megakernel" in text
    assert plan.executed_path == lower.DECODE_MEGAKERNEL
    plan.record_downgrade("test", lower.DECODE_MEGAKERNEL,
                          lower.QPROJ_ATTENTION)
    assert plan.executed_path == lower.QPROJ_ATTENTION
    assert plan.predicted_kv_pages([0, 1, 16, 17], 16) == 0 + 1 + 1 + 2
    assert plan.predicted_kv_page_words([17], 16, 2, 32, 3) == \
        2 * 16 * 2 * 2 * 32 * 3
    # 64-key tiles: rows of 64 and 640 keys read 1 and 10 tiles of 10
    assert plan.block_skip_fraction([64, 640]) == 1 - 11 / 20
    assert plan.block_skip_fraction([]) == 0.0
