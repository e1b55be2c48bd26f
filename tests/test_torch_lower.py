"""The port's configs, decision rule and serving plan against the JAX
package's: the same (phase, n, bucket, path) for every resolution over
grids that cross the prefill crossover M = N and the decode crossover
C = 2N, for the smoke and the full configs.  Impl strings differ by
design (cuda/torch against xla/pallas) and are not compared."""

import dataclasses

import pytest
import torch

from repro import configs as jax_configs
from repro import lower as jax_lower
from repro.core import analytical as jax_analytical
from repro.core import fusion as jax_fusion

from repro_torch import configs
from repro_torch import lower
from repro_torch.core import analytical, fusion

torch.set_num_threads(2)

CASES = [(arch, smoke) for arch in configs.list_archs("dense")
         for smoke in (True, False)]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_config_fields_match_jax(arch, smoke):
    ours = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
    theirs = dataclasses.asdict(jax_configs.get_config(arch, smoke=smoke))
    assert ours == theirs


def test_decision_rule_matches_jax():
    for n in (32, 128):
        for m in range(1, 4 * n, 5):
            assert fusion.select_schedule(m, n) == \
                jax_fusion.select_schedule(m, n)
            assert analytical.alpha(m, n) == jax_analytical.alpha(m, n)
            for phase in ("prefill", "decode"):
                for c in (1, n, 2 * n, 2 * n + 1, 8 * n):
                    assert fusion.phase_policy(phase, m, c, n) == \
                        jax_fusion.phase_policy(phase, m, c, n)
                    assert analytical.alpha_kv(m, c, n) == \
                        jax_analytical.alpha_kv(m, c, n)


def _drive(plan, n):
    """The same dispatch calls on a port or JAX ServingPlan: prefill
    rows across M = N, decode contexts across C = 2N, multi-row chunks
    and whole-batch steps."""
    for rows in range(1, 4 * n + 2, 3):
        plan.prefill_dispatch(rows)
    for ctx in range(1, 8 * n, 5):
        plan.decode_dispatch(ctx)
    for rows in (1, 3, n, 48):
        for ctx in (rows, rows + 1, 2 * n, 2 * n + 1, 6 * n + 7):
            plan.chunk_dispatch(ctx, rows)
    for lens in ([0], [2 * n - 1, 3], [2 * n, 1], [5 * n, 0, 2 * n]):
        plan.step_dispatch(lens)
    return [r[:4] for r in plan.resolutions]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_serving_plan_resolutions_match_jax(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    max_len = 8 * cfg.head_dim
    ours = lower.serving_plan(cfg, max_len, device="cpu", n_blocks=1)
    theirs = jax_lower.serving_plan(
        jax_configs.get_config(arch, smoke=smoke), max_len,
        backend="cpu", n_blocks=1)
    got = _drive(ours, cfg.head_dim)
    assert got == _drive(theirs, cfg.head_dim)
    paths = {r[3] for r in got}
    want = {lower.UNFUSED, lower.FUSED_ATTENTION}
    if not cfg.qk_norm:
        want |= {lower.QPROJ_ATTENTION, lower.DECODE_MEGAKERNEL}
    assert paths == want


@pytest.mark.parametrize("arch", configs.list_archs("dense"))
def test_downgrade_ledger_matches_jax(arch):
    """qk-norm walks the planned Q-fusion rungs down to fused attention
    and records it, as the JAX plan does."""
    cfg = configs.get_config(arch, smoke=True)
    ours = lower.serving_plan(cfg, 256, device="cpu", n_blocks=1)
    theirs = jax_lower.serving_plan(
        jax_configs.get_config(arch, smoke=True), 256, backend="cpu",
        n_blocks=1)
    for plan in (ours, theirs):
        plan.decode_dispatch(200)
        plan.chunk_dispatch(200, 48)
    for (_, _, _, path, _), (_, _, _, jpath, _) in zip(ours.resolutions,
                                                       theirs.resolutions):
        assert path == jpath
    p = lower.resolve_plan(cfg, "decode", 200, n_blocks=1)
    q = jax_lower.resolve_plan(jax_configs.get_config(arch, smoke=True),
                               "decode", 200, n_blocks=1)
    assert [(d.reason, d.from_path, d.to_path) for d in p.downgrades] == \
        [(d.reason, d.from_path, d.to_path) for d in q.downgrades]


def test_impl_mapping():
    assert lower.impl_for(lower.UNFUSED, "cuda") == "reference"
    assert lower.impl_for(lower.FUSED_ATTENTION, "cuda") == "cuda"
    assert lower.impl_for(lower.DECODE_MEGAKERNEL, "cpu") == "torch"
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    plan = lower.serving_plan(cfg, 160, device="cpu")
    assert plan.decode_dispatch(100).impl == "torch"
    assert plan.decode_dispatch(10).impl == "reference"


@pytest.mark.parametrize("phase,n,hd,want", [
    ("decode", 40, 32, 64), ("decode", 65, 32, 128),
    ("prefill", 200, 32, 256), ("prefill", 1, 128, 1),
    ("decode", 257, 128, 512)])
def test_bucket_for_matches_jax(phase, n, hd, want):
    from repro.lower.cache import bucket_for as jax_bucket_for
    assert lower.bucket_for(phase, n, hd) == want == \
        jax_bucket_for(phase, n, hd)


def test_plan_device_has_no_default():
    """Neither a ServingPlan nor a dispatch picks a device by itself:
    the device decides whether a fused path runs its kernel."""
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    with pytest.raises(TypeError, match="device"):
        lower.ServingPlan(cfg=cfg, max_len=160)
    plan = lower.resolve_plan(cfg, "decode", 100, n_blocks=1)
    with pytest.raises(TypeError, match="device"):
        lower.dispatch(plan)
    assert lower.dispatch(plan, device="cuda").impl == "cuda"
