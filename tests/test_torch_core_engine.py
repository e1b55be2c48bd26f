"""The port's DSE core (``repro_torch.core``) against the JAX package's
(``repro.core``): the Fig. 4 GAP8 points, the single-core engine's seed
goldens, the paper's Eqs. 3-9 peaks, communication on a multi-core
array and the phase-aware workloads.  Both are pure Python with the
same arithmetic, so every Result must be equal field for field, exactly
(no tolerance)."""

import dataclasses
import hashlib

import pytest

from repro.core import analytical as jan
from repro.core import fusion as jfusion
from repro.core import scheduler as jsch
from repro.core import validation as jvalidation
from repro.core import workload as jwl
from repro.core.accelerator import (gap8 as jgap8,
                                    multi_core_array as jmulti_core_array,
                                    pe_array_64x64 as jpe_array_64x64,
                                    tpu_v5e_like as jtpu_v5e_like)

from repro_torch.core import analytical as an
from repro_torch.core import fusion
from repro_torch.core import scheduler as sch
from repro_torch.core import validation
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import (gap8, multi_core_array,
                                          pe_array_64x64, tpu_v5e_like)


def _fields(res) -> dict:
    return dataclasses.asdict(res)


@pytest.mark.parametrize("seq,stream_est", [(81, 1.693), (128, 3.5425)])
def test_fig4_points_match_the_paper_and_jax(seq, stream_est):
    """The Fig. 4 GAP8 points: 1.693 / 3.5425 Mcycles within 0.1%, and
    the port's ValidationPoint equal to the JAX package's."""
    v = validation.validate(seq)
    assert v.modeled_mcycles == pytest.approx(stream_est, rel=1e-3)
    assert 0.05 < v.deviation_vs_measured < 0.11
    assert dataclasses.asdict(v) == dataclasses.asdict(
        jvalidation.validate(seq))


def test_validate_all_and_mac_counts_match_jax():
    ours = [dataclasses.asdict(v) for v in validation.validate_all()]
    assert ours == [dataclasses.asdict(v)
                    for v in jvalidation.validate_all()]
    assert an.mhsa_macs(81, 32, 8, 32) == 6_013_440
    assert an.mhsa_macs(128, 32, 8, 32) == 12_582_912


# Golden values of the seed scheduler for every fusion.candidates()
# schedule on a 256x256 head at row_block=4, as tests/test_core_engine.py
# pins them: (latency_cycles, energy_pj, energy_scaled_pj,
# peak_active_words, len(trace), sha256(repr(trace))[:16]).
SEED_GOLD_256 = (
    [(20480.0, 93297049.60000038, 86108464.03018497, 196608, 387,
      "b9a3ec415c25078e")] * 6
    + [(20480.0, 93165977.60000038, 86080086.10975377, 196608, 323,
        "fe0e1af6b6bb12cd")]
    + [(20480.0, 93034905.6000002, 86051708.18932238, 196608, 323,
        "944bbe78293eff60")] * 6
    + [(20480.0, 92903833.60000011, 86023330.26889108, 196608, 259,
        "2e262ce193a29ae7")]
)


@pytest.mark.parametrize("i", range(len(SEED_GOLD_256)))
def test_single_core_seed_goldens_bit_equal(i):
    cand, jcand = fusion.candidates()[i], jfusion.candidates()[i]
    assert cand.name == jcand.name
    res = sch.evaluate(wl.attention_head(256, 256), pe_array_64x64(), cand,
                       row_block=4)
    jres = jsch.evaluate(jwl.attention_head(256, 256), jpe_array_64x64(),
                         jcand, row_block=4)
    sha = hashlib.sha256(repr(res.trace).encode()).hexdigest()[:16]
    assert (res.latency_cycles, res.energy_pj, res.energy_scaled_pj,
            res.peak_active_words, len(res.trace), sha) == SEED_GOLD_256[i]
    assert _fields(res) == _fields(jres)
    assert res.comm_cycles == 0.0 and res.link_utilization == {}


SHAPES = [(128, 512), (512, 128), (256, 256), (128, 1024), (1024, 128)]


@pytest.mark.parametrize("M,N", SHAPES)
@pytest.mark.parametrize("preset", ["lbl", "fuse_q_qkt", "fuse_pv",
                                    "fuse_all"])
def test_head_presets_equal_jax_and_the_analytical_peaks(M, N, preset):
    """Each Fig. 5 preset on an M x N head: the port's Result equals
    JAX's, and the LBL / layer-fused peaks are Eqs. 3-9's."""
    rb = max(1, M // 64)
    res = sch.evaluate(wl.attention_head(M, N), pe_array_64x64(),
                       getattr(fusion, preset)(), row_block=rb)
    jres = jsch.evaluate(jwl.attention_head(M, N), jpe_array_64x64(),
                         getattr(jfusion, preset)(), row_block=rb)
    assert _fields(res) == _fields(jres)
    if preset == "lbl":
        assert res.peak_active_words == an.a_lbl(M, N)
    if preset == ("fuse_q_qkt" if M < N else "fuse_pv"):
        assert res.peak_active_words == an.a_lf(M, N)


def _split(mod, prefix=""):
    """QKV projections on core 0, the score pipeline on core 1."""
    p = prefix
    return mod.Schedule(name="split", stages=(
        mod.Stage(layers=(f"{p}Q",), core=0),
        mod.Stage(layers=(f"{p}K",), core=0),
        mod.Stage(layers=(f"{p}V",), core=0),
        mod.Stage(layers=(f"{p}QKT",), core=1),
        mod.Stage(layers=(f"{p}SM",), core=1),
        mod.Stage(layers=(f"{p}AV",), core=1)))


@pytest.mark.parametrize("cores", [2, 4])
def test_cross_core_communication_equals_jax(cores):
    res = sch.evaluate(wl.attention_head(256, 256), multi_core_array(cores),
                       _split(sch), row_block=4)
    jres = jsch.evaluate(jwl.attention_head(256, 256),
                         jmulti_core_array(cores), _split(jsch), row_block=4)
    assert res.comm_cycles > 0
    assert _fields(res) == _fields(jres)


@pytest.mark.parametrize("accel", ["gap8", "pe_array_64x64", "tpu_v5e_like"])
def test_platform_models_equal_jax(accel):
    """The DSE's platform models are inputs the goldens need: equal
    field for field (they describe the hardware they name, not the
    card)."""
    ours = {"gap8": gap8, "pe_array_64x64": pe_array_64x64,
            "tpu_v5e_like": tpu_v5e_like}[accel]()
    theirs = {"gap8": jgap8, "pe_array_64x64": jpe_array_64x64,
              "tpu_v5e_like": jtpu_v5e_like}[accel]()
    assert repr(ours) == repr(theirs)
    res = sch.evaluate(wl.attention_head(128, 64), ours, fusion.fuse_pv(),
                       row_block=8)
    jres = jsch.evaluate(jwl.attention_head(128, 64), theirs,
                         jfusion.fuse_pv(), row_block=8)
    assert _fields(res) == _fields(jres)


@pytest.mark.parametrize("M,n_ctx", [(1, 64), (1, 512), (4, 300)])
def test_kv_cached_head_equals_jax(M, n_ctx):
    w = wl.kv_cached_attention(M, n_ctx, 64)
    jw = jwl.kv_cached_attention(M, n_ctx, 64)
    for name in ("lbl", "fuse_q_qkt", "fuse_pv", "fuse_all"):
        res = sch.evaluate(w, pe_array_64x64(), getattr(fusion, name)(),
                           row_block=1)
        jres = jsch.evaluate(jw, jpe_array_64x64(),
                             getattr(jfusion, name)(), row_block=1)
        assert _fields(res) == _fields(jres)
    assert an.alpha_kv(M, n_ctx, 64) == jan.alpha_kv(M, n_ctx, 64)


def test_illegal_schedules_raise_in_both():
    bad = [("AV",), ("Q",), ("K",), ("V",), ("QKT",), ("SM",)]
    with pytest.raises(sch.IllegalSchedule):
        sch.evaluate(wl.attention_head(64, 64), pe_array_64x64(),
                     sch.Schedule(name="bad", stages=tuple(
                         sch.Stage(layers=s) for s in bad)), row_block=8)
    with pytest.raises(jsch.IllegalSchedule):
        jsch.evaluate(jwl.attention_head(64, 64), jpe_array_64x64(),
                      jsch.Schedule(name="bad", stages=tuple(
                          jsch.Stage(layers=s) for s in bad)), row_block=8)
    with pytest.raises(sch.IllegalSchedule):
        sch.Stage(layers=("Q",), streamed=frozenset({("Q", "QKT")}))
