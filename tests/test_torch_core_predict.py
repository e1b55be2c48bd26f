"""The port's plan predictions against the JAX package's: the DSE
engine's latency cycles and peak active words of a lowered plan
(``ExecutionPlan.predict`` on the default platform) are equal, exactly,
for every ported dense config.  At smoke width the whole lowering grid
runs at two blocks with the rule's choice and the forced
counterfactuals (prefill: the rule's choice and LBL); at full width
(about half a second a block here) one block, the decode cells either
side of C = 2N and one prefill cell."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro import lower as jlower

from repro_torch import configs, lower

DENSE = ["starcoder2-7b", "qwen3-8b", "qwen3-14b", "starcoder2-15b"]
FLAGS = [(None, None, None), (False, False, None), (True, True, None),
         (True, True, True)]


def _predicted(plan) -> tuple:
    r = plan.predict()
    return (r.latency_cycles, r.peak_active_words, r.energy_pj, r.macs,
            r.kv_cache_words)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_predictions_equal_jax(arch, phase):
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    n = cfg.head_dim
    cells = [(m, 1) for m in (32, 127, 128, 129)] if phase == "prefill" \
        else [(c, t) for c in (2 * n - 1, 2 * n, 2 * n + 1, 4096)
              for t in (1, 4)]
    # prefill at M <= 129 has no megakernel, and its fused counterfactual
    # costs as much as the rule's: the rule's choice and LBL carry it
    flags = FLAGS[:2] if phase == "prefill" else FLAGS
    for length, tokens in cells:
        for fq, fs, fb in flags:
            kw = dict(decode_tokens=tokens, n_blocks=2, fuse_q=fq,
                      fuse_scores=fs, fuse_block=fb)
            ours = lower.lower(cfg, phase, length, **kw)
            theirs = jlower.lower(jcfg, phase, length, **kw)
            assert _predicted(ours) == _predicted(theirs), \
                (length, tokens, fq, fs, fb)
            assert ours.predicted_cycles == theirs.predicted_cycles
            assert ours.predicted_peak_words == theirs.predicted_peak_words


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_predictions_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    n = cfg.head_dim
    for phase, length, tokens in (("decode", 2 * n, 1),
                                  ("decode", 2 * n + 1, 1),
                                  ("decode", 2 * n + 1, 4),
                                  ("prefill", 32, 1)):
        ours = lower.lower(cfg, phase, length, decode_tokens=tokens)
        theirs = jlower.lower(jcfg, phase, length, decode_tokens=tokens)
        assert _predicted(ours) == _predicted(theirs), (phase, length)


def test_predict_memoizes_only_the_default_platform():
    from repro_torch.core.accelerator import multi_core_array
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    plan = lower.lower(cfg, "decode", 4096)
    first = plan.predict()
    assert plan.predict() is first
    other = plan.predict(multi_core_array(2))
    assert other is not first
    assert plan.predict(row_block=1) is not first
    assert plan.predict() is first


def test_group_5_and_12_lowering_predicts_like_jax():
    """The new configs' GQA groups (40 heads over 8, 48 over 4) at a
    narrow width: equal plans and predictions in both packages."""
    for arch, heads, kv in (("qwen3-14b", 10, 2), ("starcoder2-15b", 12, 1)):
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                  n_heads=heads, n_kv_heads=kv,
                                  d_model=heads * 32)
        jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                                   n_heads=heads, n_kv_heads=kv,
                                   d_model=heads * 32)
        for phase, length in (("prefill", 128), ("decode", 65),
                              ("decode", 4096)):
            ours = lower.lower(cfg, phase, length, n_blocks=2)
            theirs = jlower.lower(jcfg, phase, length, n_blocks=2)
            assert ours.kernel_path == theirs.kernel_path
            assert _predicted(ours) == _predicted(theirs)
            kv_layers = [l for l in ours.source.workload.layers
                         if l.startswith("b0.kv") and l.endswith(".K")]
            assert len(kv_layers) == kv
