"""The port's heterogeneous GA allocator (``repro_torch.core.allocation``)
and its GAP8/CCT config (``repro_torch.configs.gap8_cct``) against the
JAX package's: the cases of ``tests/test_allocation_hetero.py`` with
its seeds, run through both copies.  Both are pure Python with the same
arithmetic and draw every random number from one ``random.Random(seed)``,
so every genome, fitness and Result must be equal field for field,
exactly (no tolerance).  The reference's two property tests (which need
``hypothesis``) become a grid over its strategies' ranges."""

import dataclasses
import random

import pytest

from repro.configs import gap8_cct as jgap8_cct
from repro.core import accelerator as jacc
from repro.core import allocation as jga
from repro.core import scheduler as jsch
from repro.core import workload as jwl

import repro_torch.core as core
from repro_torch.configs import gap8_cct
from repro_torch.core import accelerator as acc
from repro_torch.core import allocation as ga
from repro_torch.core import scheduler as sch
from repro_torch.core import workload as wl


def _same_ga(mine, ref) -> None:
    assert mine.allocation == ref.allocation
    assert mine.softmax_allocation == ref.softmax_allocation
    assert mine.fitness == ref.fitness
    assert (mine.generations, mine.evaluations) == \
        (ref.generations, ref.evaluations)
    assert dataclasses.asdict(mine.result) == dataclasses.asdict(ref.result)


def _small(mod, accel, n_heads, seed, **kw):
    kw.setdefault("population", 6)
    kw.setdefault("generations", 3)
    return mod.optimize_allocation(8, 8, n_heads, accel, seed=seed, **kw)


#: the reference's hypothesis ranges (n_pe 1-2, n_simd 1-2, n_mxu 0-1,
#: n_heads 1-4, seed 0-99), a grid of them
PLATFORMS = [(1, 1, 0), (2, 1, 1), (1, 2, 1), (2, 2, 0)]
HETERO = [(p, n_heads, seed) for p, n_heads, seed in
          [(PLATFORMS[0], 1, 0), (PLATFORMS[1], 2, 7), (PLATFORMS[2], 3, 42),
           (PLATFORMS[3], 4, 99), (PLATFORMS[1], 4, 13),
           (PLATFORMS[2], 2, 58)]]


@pytest.mark.parametrize("platform,n_heads,seed", HETERO)
def test_hetero_ga_bit_equal_and_legal(platform, n_heads, seed):
    """The hetero genome search on the reference's platforms: the port's
    result equals the JAX package's exactly, is deterministic per seed,
    and its genomes are legal (every head on a core, every softmax gene
    the head's own core or a SIMD core, a feasible Result)."""
    accel, jaccel = acc.hetero_platform(*platform), \
        jacc.hetero_platform(*platform)
    mine = _small(ga, accel, n_heads, seed)
    _same_ga(mine, _small(jga, jaccel, n_heads, seed))
    _same_ga(_small(ga, accel, n_heads, seed), mine)
    simd = {i for i, c in enumerate(accel.cores) if c.simd is not None}
    assert len(mine.allocation) == n_heads
    assert all(0 <= c < accel.n_cores for c in mine.allocation)
    assert mine.softmax_allocation is not None
    assert all(s == c or s in simd
               for c, s in zip(mine.allocation, mine.softmax_allocation))
    assert isinstance(mine.result, sch.Result)
    assert mine.fitness < float("inf")


def test_homogeneous_path_unchanged():
    """Identical cores: the plain head->core genome, no softmax gene,
    equal to the JAX package's."""
    mine = ga.optimize_allocation(16, 16, 4, acc.multi_core_array(2), seed=0)
    _same_ga(mine, jga.optimize_allocation(16, 16, 4,
                                           jacc.multi_core_array(2), seed=0))
    assert mine.softmax_allocation is None


def test_ga_offloads_softmax_to_simd_core():
    """1 PE array + 1 SIMD-heavy core: every head's softmax streams to
    the SIMD core, the fitness beats the all-PE no-offload allocation,
    and both equal the JAX package's."""
    accel = acc.hetero_platform(1, 1)
    mine = ga.optimize_allocation(64, 16, 2, accel, generations=6,
                                  population=8, seed=0)
    _same_ga(mine, jga.optimize_allocation(64, 16, 2,
                                           jacc.hetero_platform(1, 1),
                                           generations=6, population=8,
                                           seed=0))
    simd = acc.widest_simd_core(accel)
    assert mine.softmax_allocation is not None
    assert all(s == simd for s in mine.softmax_allocation)
    all_pe = sch.evaluate(wl.parallel_heads(64, 16, 2), accel,
                          ga.heads_schedule(64, 16, (0, 0)), row_block=1)
    jall_pe = jsch.evaluate(jwl.parallel_heads(64, 16, 2),
                            jacc.hetero_platform(1, 1),
                            jga.heads_schedule(64, 16, (0, 0)), row_block=1)
    assert dataclasses.asdict(all_pe) == dataclasses.asdict(jall_pe)
    assert mine.fitness < all_pe.latency_cycles


@pytest.mark.parametrize("allocation", [(0, 0, 0, 0), (0, 0, 0, 1),
                                        (0, 1, 0, 1)])
def test_head_partition_schedule_matches_jax(allocation):
    """The head-partitioned MHSA schedule and its Result, equal to the
    JAX package's for each allocation of the reference's comm test."""
    workload, schedule = ga.head_partition_schedule(64, 256, 4, 64,
                                                    allocation)
    jworkload, jschedule = jga.head_partition_schedule(64, 256, 4, 64,
                                                       allocation)
    assert schedule.name == jschedule.name
    assert [dataclasses.asdict(s) for s in schedule.stages] == \
        [dataclasses.asdict(s) for s in jschedule.stages]
    res = sch.evaluate(workload, acc.multi_core_array(2), schedule,
                       row_block=1)
    jres = jsch.evaluate(jworkload, jacc.multi_core_array(2), jschedule,
                         row_block=1)
    assert dataclasses.asdict(res) == dataclasses.asdict(jres)


def test_head_partition_comm_monotone():
    """comm_cycles: zero with every head on the root core, and growing
    with the number of off-root heads."""
    accel = acc.multi_core_array(2)

    def comm(allocation):
        workload, schedule = ga.head_partition_schedule(
            64, 256, 4, 64, allocation)
        return sch.evaluate(workload, accel, schedule,
                            row_block=1).comm_cycles

    single, skew, rr = (comm(a) for a in ((0, 0, 0, 0), (0, 0, 0, 1),
                                          (0, 1, 0, 1)))
    assert single == 0.0
    assert 0.0 < skew < rr


def _initial_population(seed, n_heads, n_cores, population):
    """Replay of optimize_allocation's homogeneous seeding."""
    rng = random.Random(seed)
    pop = [tuple(h % n_cores for h in range(n_heads))]
    while len(pop) < population:
        pop.append(tuple(rng.randrange(n_cores) for _ in range(n_heads)))
    return pop


def _spied(mod, monkeypatch, seed):
    """Every genome ``mod``'s GA evaluates with mutation_rate=0.0."""
    seen = []
    orig = mod.heads_schedule

    def spy(M, N, allocation, policy="auto", sm_allocation=None):
        seen.append(tuple(allocation))
        return orig(M, N, allocation, policy, sm_allocation=sm_allocation)

    monkeypatch.setattr(mod, "heads_schedule", spy)
    accel = (acc if mod is ga else jacc).multi_core_array(12)
    res = mod.optimize_allocation(16, 16, 4, accel, population=3,
                                  generations=10, mutation_rate=0.0,
                                  seed=seed)
    return seen, res


@pytest.mark.parametrize("seed", range(5))
def test_mutation_rate_zero_is_crossover_only(monkeypatch, seed):
    """With mutation_rate=0.0 every evaluated genome draws each gene from
    the initial population's alleles at that locus; the port evaluates
    the JAX package's genomes in its order."""
    seen, res = _spied(ga, monkeypatch, seed)
    jseen, jres = _spied(jga, monkeypatch, seed)
    assert seen == jseen
    _same_ga(res, jres)
    locus = [{g[i] for g in _initial_population(seed, 4, 12, 3)}
             for i in range(4)]
    assert seen
    for genome in seen:
        for i, allele in enumerate(genome):
            assert allele in locus[i], (seed, genome, i)


def test_no_feasible_genome_raises_like_jax():
    """A platform whose only cores lack a SIMD unit (MXU-like) has no
    legal softmax core: both searches raise IllegalSchedule."""
    with pytest.raises(jsch.IllegalSchedule) as want:
        jga.optimize_allocation(8, 8, 2, jacc.hetero_platform(0, 0, 2),
                                population=4, generations=2, seed=0)
    with pytest.raises(sch.IllegalSchedule) as got:
        ga.optimize_allocation(8, 8, 2, acc.hetero_platform(0, 0, 2),
                               population=4, generations=2, seed=0)
    assert str(got.value) == str(want.value)


def test_core_exports_the_allocator():
    assert core.allocation is ga
    assert core.optimize_allocation is ga.optimize_allocation
    assert core.heads_schedule is ga.heads_schedule
    assert core.GAResult is ga.GAResult


@pytest.mark.parametrize("seq_len", gap8_cct.SEQ_LENS)
def test_gap8_cct_config_matches_jax(seq_len):
    """The paper's GAP8/CCT validation config: the same constants, the
    same accelerator and workload, and that workload evaluated
    layer by layer on that accelerator to the JAX package's Result."""
    assert (gap8_cct.SEQ_LENS, gap8_cct.N_HEADS, gap8_cct.D_MODEL,
            gap8_cct.D_HEAD) == (jgap8_cct.SEQ_LENS, jgap8_cct.N_HEADS,
                                 jgap8_cct.D_MODEL, jgap8_cct.D_HEAD)
    accel, jaccel = gap8_cct.make_accelerator(), jgap8_cct.make_accelerator()
    assert dataclasses.asdict(accel) == dataclasses.asdict(jaccel)
    workload = gap8_cct.make_workload(seq_len)
    jworkload = jgap8_cct.make_workload(seq_len)
    assert list(workload.layers) == list(jworkload.layers)
    res = sch.evaluate(workload, accel, sch.layer_by_layer(workload),
                       row_block=1)
    jres = jsch.evaluate(jworkload, jaccel, jsch.layer_by_layer(jworkload),
                         row_block=1)
    assert dataclasses.asdict(res) == dataclasses.asdict(jres)
    assert res.latency_cycles > 0
