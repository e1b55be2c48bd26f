"""The port's schedule explorer and space generator against the JAX
package's, on the cases of tests/test_spacegen.py and
tests/test_core_scheduler.py: the same ranked candidates (schedule and
Result, field for field), the same generated spaces, and the same
static-validation verdicts."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.core import fusion as jfusion
from repro.core import scheduler as jsch
from repro.core import spacegen as jspacegen
from repro.core import validation as jvalidation
from repro.core import workload as jwl
from repro.core.accelerator import multi_core_array as jmulti_core_array

from repro_torch import configs
from repro_torch.core import fusion, spacegen, validation
from repro_torch.core import scheduler as sch
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import multi_core_array, pe_array_64x64


def _ranked(evals) -> list:
    return [(dataclasses.asdict(e.schedule), dataclasses.asdict(e.result))
            for e in evals]


def _schedules(scheds) -> list:
    return [dataclasses.asdict(s) for s in scheds]


@pytest.mark.parametrize("M,N", [(128, 1024), (1024, 128), (256, 256),
                                 (4, 8), (64, 32)])
def test_explore_head_ranks_like_jax(M, N):
    ours = fusion.explore(M, N)
    assert _ranked(ours) == _ranked(jfusion.explore(M, N))
    best = fusion.best_schedule(M, N)
    assert best.schedule.name == jfusion.best_schedule(M, N).schedule.name
    want = {"fuse_q_qkt": "fuse[Q->QKT]", "fuse_pv": "fuse[QKT->SM->AV]"}
    rule = fusion.select_schedule(M, N)
    if rule in want:
        assert best.schedule.name == want[rule]


@pytest.mark.parametrize("n_heads,cores", [(2, 2), (4, 2)])
def test_multi_head_space_ranks_like_jax(n_heads, cores):
    ours = fusion.explore(128, 64, accel=multi_core_array(cores),
                          n_heads=n_heads, row_block=16)
    theirs = jfusion.explore(128, 64, accel=jmulti_core_array(cores),
                             n_heads=n_heads, row_block=16)
    assert _ranked(ours) == _ranked(theirs)


@pytest.mark.parametrize("M,N", [(256, 128), (128, 256), (64, 64)])
def test_generated_head_space_equals_jax(M, N):
    ours = spacegen.generate(wl.attention_head(M, N), 1)
    assert _schedules(ours) == _schedules(
        jspacegen.generate(jwl.attention_head(M, N), 1))
    got = {(r.latency_cycles, r.peak_active_words) for r in (
        sch.evaluate(wl.attention_head(M, N), pe_array_64x64(), g,
                     row_block=8) for g in ours)}
    for preset in (fusion.lbl(), fusion.fuse_q_qkt(), fusion.fuse_pv()):
        r = sch.evaluate(wl.attention_head(M, N), pe_array_64x64(), preset,
                         row_block=8)
        assert (r.latency_cycles, r.peak_active_words) in got


def _block(mod, norm="pre", heads=2, kv=2):
    return mod.transformer_block(32, 64, heads, 128, n_kv_heads=kv,
                                 d_head=32, norm=norm)


@pytest.mark.parametrize("norm", ["pre", "post"])
def test_explore_block_ranks_like_jax(norm):
    opts = dict(max_orderings=3, max_cuts=8, max_candidates=24)
    ours = fusion.explore(_block(wl, norm), space=spacegen.SpaceOptions(
        **opts), latency_tolerance=1e9)
    theirs = jfusion.explore(_block(jwl, norm),
                             space=jspacegen.SpaceOptions(**opts),
                             latency_tolerance=1e9)
    assert _ranked(ours) == _ranked(theirs)
    assert _schedules([sch.layer_by_layer(_block(wl, norm))]) == \
        _schedules([jsch.layer_by_layer(_block(jwl, norm))])


def test_explore_block_multicore_ranks_like_jax():
    opts = dict(max_orderings=2, max_cuts=6, max_candidates=16)
    ours = fusion.explore(_block(wl), accel=multi_core_array(2),
                          space=spacegen.SpaceOptions(**opts),
                          latency_tolerance=10.0)
    theirs = jfusion.explore(_block(jwl), accel=jmulti_core_array(2),
                             space=jspacegen.SpaceOptions(**opts),
                             latency_tolerance=10.0)
    assert _ranked(ours) == _ranked(theirs)
    assert any(e.result.comm_cycles > 0 for e in ours)


@pytest.mark.parametrize("arch", configs.list_archs("dense"))
def test_model_config_block_explores_like_jax(arch):
    """A one-block workload of each ported config (smoke width), built
    through ``from_model_config``, explores to the same ranking."""
    opts = dict(max_orderings=2, max_cuts=4, max_candidates=8)
    blk = wl.from_model_config(configs.get_config(arch, smoke=True), 16)
    jblk = jwl.from_model_config(jconfigs.get_config(arch, smoke=True), 16)
    assert blk.name == jblk.name
    ours = fusion.explore(blk, space=spacegen.SpaceOptions(**opts),
                          row_block=16, latency_tolerance=1.10)
    theirs = jfusion.explore(jblk, space=jspacegen.SpaceOptions(**opts),
                             row_block=16, latency_tolerance=1.10)
    assert ours and _ranked(ours) == _ranked(theirs)
    for e in ours:
        assert validation.validate_schedule(blk, e.schedule) == []


def test_unsupported_config_raises_like_jax():
    ssm = configs.get_config("mamba2-130m", smoke=True)
    with pytest.raises(ValueError):
        wl.from_model_config(ssm, 8)
    with pytest.raises(ValueError):
        jwl.from_model_config(jconfigs.get_config("mamba2-130m", smoke=True),
                              8)


def _bad_schedules(mod):
    S = mod.Stage
    return [
        mod.Schedule(name="bad", stages=(
            S(layers=("AV",)), S(layers=("Q",)), S(layers=("K",)),
            S(layers=("V",)), S(layers=("QKT",)), S(layers=("SM",)))),
        mod.Schedule(name="missing", stages=(S(layers=("Q",)),)),
        mod.Schedule(name="stream", stages=(
            S(layers=("Q",)), S(layers=("K",)),
            S(layers=("V", "AV", "QKT", "SM"),
              streamed=frozenset({("V", "AV")})))),
    ]


@pytest.mark.parametrize("i", range(3))
def test_validate_schedule_verdicts_equal_jax(i):
    ours = validation.validate_schedule(wl.attention_head(32, 32),
                                        _bad_schedules(sch)[i])
    theirs = jvalidation.validate_schedule(jwl.attention_head(32, 32),
                                           _bad_schedules(jsch)[i])
    assert ours and ours == theirs
    assert validation.validate_schedule(wl.attention_head(32, 32),
                                        fusion.fuse_pv()) == []


def test_streamable_edges_equal_jax():
    assert spacegen.streamable_edges(wl.attention_head(128, 64)) == \
        jspacegen.streamable_edges(jwl.attention_head(128, 64))
    w = wl.gqa_attention(32, 64, 4, n_kv_heads=2, d_head=16)
    jw = jwl.gqa_attention(32, 64, 4, n_kv_heads=2, d_head=16)
    assert spacegen.streamable_edges(w) == jspacegen.streamable_edges(jw)
    assert list(w.layers) == list(jw.layers)
