"""Step 4 of Stream: genetic-algorithm layer(-group)-to-core allocation
(the port's copy of ``repro/core/allocation.py``, names and arithmetic
unchanged, so a seed gives the reference's genomes and fitness bit for
bit).

The paper reuses Stream's GA unchanged ('a genetic algorithm optimizes
which layer should be allocated to which core'; steps 4 and 5 iterate).
For transformer workloads the natural allocation unit is the attention
head — heads share no weights and, per Sec. IV.C.3, parallelise across
cores with unchanged per-core memory gain.

The GA genome maps head -> core; fitness is the Step-5 scheduler's
latency (optionally blended with the max per-core feature-memory peak
and the schedule's communication cycles).  The event-driven engine
books every cross-core tensor movement — input broadcast included — on
the platform interconnect, so latency is already communication-aware;
``comm_weight`` adds *explicit* pressure against link-heavy allocations
on top (useful when links are shared with other tenants or when energy
matters more than the critical path).  Deterministic for a given seed.

On *heterogeneous* platforms (``accelerator.is_heterogeneous``) the
genome grows a second gene per head: the core executing that head's
softmax.  A head placed on a matmul-oriented core can stream its score
rows to a SIMD-heavy core and back (``fusion.softmax_offload``) when
the link toll beats the narrow local vector unit — the engine prices
both sides, and infeasible genomes (a vector node on a SIMD-less
MXU-like core) score +inf instead of aborting the search.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from repro_torch.core import accelerator as acc
from repro_torch.core import fusion
from repro_torch.core import scheduler as sch
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import Accelerator


def head_schedule(M: int, N: int, prefix: str, core: int,
                  policy: str = "auto",
                  sm_core: Optional[int] = None) -> list[sch.Stage]:
    """Stages for one head under the given fusion policy.  With
    ``sm_core`` set to a different core, the softmax stage executes
    there (``fusion.softmax_offload``: the score pipeline's edges
    become cross-core streamed edges)."""
    if policy == "auto":
        policy = fusion.select_schedule(M, N)
    if sm_core is not None and sm_core != core:
        return list(fusion.softmax_offload(prefix, core, sm_core,
                                           policy=policy).stages)
    builder = {
        "lbl": lambda: fusion.lbl(prefix, core),
        "fuse_q_qkt": lambda: fusion.fuse_q_qkt(prefix, core),
        "fuse_pv": lambda: fusion.fuse_pv(prefix, core),
        "fuse_all": lambda: fusion.fuse_all(prefix, core),
    }[policy]
    return list(builder().stages)


def heads_schedule(M: int, N: int, allocation: tuple[int, ...],
                   policy: str = "auto",
                   sm_allocation: Optional[tuple] = None) -> sch.Schedule:
    """Schedule a parallel_heads workload under a head->core allocation.

    Stages are emitted head-major; the executor's per-resource timelines
    make heads on different cores run concurrently.  ``sm_allocation``
    (optional, same length) names each head's softmax core — entries
    equal to the head's compute core (or None) mean no offload.
    """
    stages: list[sch.Stage] = []
    for h, core in enumerate(allocation):
        sm = sm_allocation[h] if sm_allocation is not None else None
        stages.extend(head_schedule(M, N, f"h{h}.", core, policy,
                                    sm_core=sm))
    name = f"heads[{policy}]@{allocation}"
    if sm_allocation is not None and any(
            s is not None and s != c
            for c, s in zip(allocation, sm_allocation)):
        name += f"/sm@{tuple(sm_allocation)}"
    return sch.Schedule(name=name, stages=tuple(stages))


def head_partition_schedule(
        M: int, d_model: int, n_heads: int, d_head: int,
        allocation: tuple[int, ...], *, policy: str = "auto",
        sm_allocation: Optional[tuple] = None,
) -> tuple[wl.Workload, sch.Schedule]:
    """The engine-side model of a head-partitioned (tensor-parallel)
    MHSA step: head h's projections + score pipeline + its slice of
    the output projection run on core ``allocation[h]``; the
    partial-output accumulation chain runs on the root core, so every
    partial produced elsewhere books an (M x d_model) transfer on the
    fabric — plus the input broadcast to every participating core.
    This is the analytical analogue of the all-reduce a head-parallel
    multi-device serve executes (the JAX package's
    ``launch/mesh_lowering.py``), so the ``Result.comm_cycles`` of this
    schedule is what its ``tools/validate_costmodel.py --mesh``
    compares against measured collective wall-time.
    """
    workload = wl.mhsa(M, d_model, n_heads, d_head)
    root = min(allocation)
    stages: list[sch.Stage] = []
    for h, core in enumerate(allocation):
        sm = sm_allocation[h] if sm_allocation is not None else None
        stages.extend(head_schedule(M, d_head, f"h{h}.", core, policy,
                                    sm_core=sm))
        stages.append(sch.Stage(layers=(f"proj{h}",), core=core))
        if h > 0:
            stages.append(sch.Stage(layers=(f"acc{h}",), core=root))
    return workload, sch.Schedule(
        name=f"mhsa[{policy}]@{tuple(allocation)}", stages=tuple(stages))


@dataclasses.dataclass
class GAResult:
    """Outcome of :func:`optimize_allocation`: the best head->core
    ``allocation`` genome found, its ``fitness`` (cycles, plus the
    optional memory/communication penalty terms), the full Step-5
    ``Result`` it evaluated to, and the search effort spent.  On
    heterogeneous platforms ``softmax_allocation`` carries the second
    gene per head — the core executing that head's softmax (equal to
    the head's compute core when not offloaded)."""

    allocation: tuple[int, ...]
    fitness: float
    result: sch.Result
    generations: int
    evaluations: int
    softmax_allocation: Optional[tuple[int, ...]] = None


def optimize_allocation(
    M: int, N: int, n_heads: int, accel: Accelerator, *,
    policy: str = "auto",
    row_block: Optional[int] = None,
    population: int = 16,
    generations: int = 20,
    mutation_rate: Optional[float] = None,
    memory_weight: float = 0.0,
    comm_weight: float = 0.0,
    seed: int = 0,
    fitness_fn: Optional[Callable[[sch.Result], float]] = None,
    hetero: Optional[bool] = None,
) -> GAResult:
    """Steps 4+5 iteration: evolve head->core allocations, scoring each
    with the Step-5 scheduler.

    Args:
        M, N:          head shape (rows x head dim) of each of the
                       ``n_heads`` parallel heads.
        accel:         the multi-core platform (links included).
        policy:        per-head fusion policy name, or "auto" for the
                       shape rule ``fusion.select_schedule``.
        memory_weight: pJ-free blend factor — adds
                       ``weight * max per-core peak (words)`` to the
                       latency-cycles fitness.
        comm_weight:   adds ``weight * comm_cycles`` likewise.
        fitness_fn:    full override, ``Result -> float`` (lower wins).
        hetero:        force the heterogeneous genome (per-head softmax
                       core as a second gene) on or off; default
                       auto-detects via ``accelerator.is_heterogeneous``.

    Returns a :class:`GAResult`; deterministic for a given ``seed``.
    Genomes whose schedule the engine rejects (``IllegalSchedule``,
    e.g. softmax on a SIMD-less core) score +inf and stay in the gene
    pool; if *no* feasible genome is ever found the search itself
    raises ``IllegalSchedule``.
    """
    rng = random.Random(seed)
    n_cores = accel.n_cores
    workload = wl.parallel_heads(M, N, n_heads)
    if row_block is None:
        row_block = max(1, M // 64)
    if mutation_rate is None:
        # NOT `mutation_rate or ...`: an explicit 0.0 must disable
        # mutation, not silently restore the default
        mutation_rate = 1.0 / max(n_heads, 1)
    if hetero is None:
        hetero = acc.is_heterogeneous(accel)

    cache: dict[tuple, tuple[float, Optional[sch.Result]]] = {}
    evals = 0

    def score(schedule: sch.Schedule) -> tuple[float, Optional[sch.Result]]:
        nonlocal evals
        try:
            res = sch.evaluate(workload, accel, schedule,
                               row_block=row_block)
        except sch.IllegalSchedule:
            return float("inf"), None
        finally:
            evals += 1
        if fitness_fn is not None:
            return fitness_fn(res), res
        mem = max(res.per_core_peak.values(), default=0)
        return (res.latency_cycles + memory_weight * mem
                + comm_weight * res.comm_cycles), res

    if not hetero:
        # -- homogeneous path: the original plain head->core genome ----
        def fitness(genome: tuple[int, ...]):
            if genome in cache:
                return cache[genome]
            cache[genome] = score(heads_schedule(M, N, genome, policy))
            return cache[genome]

        def random_genome() -> tuple[int, ...]:
            return tuple(rng.randrange(n_cores) for _ in range(n_heads))

        def mutate_gene(_gene: int) -> int:
            return rng.randrange(n_cores)

        # seed the population with the balanced round-robin plus randoms
        pop = [tuple(h % n_cores for h in range(n_heads))]
    else:
        # -- heterogeneous path: (core, softmax core) gene pairs -------
        simd_cores = [i for i, c in enumerate(accel.cores)
                      if c.simd is not None]
        widest = acc.widest_simd_core(accel)

        def fitness(genome: tuple):
            if genome in cache:
                return cache[genome]
            alloc = tuple(c for c, _ in genome)
            sm = tuple(s for _, s in genome)
            cache[genome] = score(
                heads_schedule(M, N, alloc, policy, sm_allocation=sm))
            return cache[genome]

        def random_gene() -> tuple[int, int]:
            c = rng.randrange(n_cores)
            opts = [c] + [s for s in simd_cores if s != c]
            return (c, opts[rng.randrange(len(opts))])

        def random_genome() -> tuple:
            return tuple(random_gene() for _ in range(n_heads))

        def mutate_gene(_gene) -> tuple[int, int]:
            return random_gene()

        def local_sm(c: int) -> int:
            # a feasible softmax core for a head computed on c: itself
            # when it has a SIMD unit, else the widest SIMD core around
            if accel.cores[c].simd is not None:
                return c
            return widest if widest is not None else c

        rr = [h % n_cores for h in range(n_heads)]
        pop = [tuple((c, local_sm(c)) for c in rr)]
        if widest is not None:
            # the paper's softmax-on-the-SIMD-core shape as a seed
            offload = tuple((c, widest) for c in rr)
            if offload != pop[0]:
                pop.append(offload)

    while len(pop) < population:
        pop.append(random_genome())
    pop = pop[:population]

    def tournament():
        cands = [pop[rng.randrange(len(pop))] for _ in range(3)]
        return min(cands, key=lambda g: fitness(g)[0])

    for gen in range(generations):
        scored = sorted(pop, key=lambda g: fitness(g)[0])
        nxt = scored[:2]  # elitism
        while len(nxt) < population:
            a, b = tournament(), tournament()
            child = tuple(a[i] if rng.random() < 0.5 else b[i]
                          for i in range(n_heads))
            child = tuple(
                mutate_gene(c) if rng.random() < mutation_rate
                else c for c in child)
            nxt.append(child)
        pop = nxt

    best = min(pop, key=lambda g: fitness(g)[0])
    f, res = fitness(best)
    if res is None:
        raise sch.IllegalSchedule(
            f"no feasible head allocation found on {accel.name}: every "
            "evaluated genome was illegal (does any core have a SIMD "
            "unit for the softmax?)")
    if not hetero:
        return GAResult(allocation=best, fitness=f, result=res,
                        generations=generations, evaluations=evals)
    return GAResult(allocation=tuple(c for c, _ in best), fitness=f,
                    result=res, generations=generations,
                    evaluations=evals,
                    softmax_allocation=tuple(s for _, s in best))
