"""Step 5 of Stream: computation-node scheduling with latency, energy and
active-feature-memory tracking (paper Sec. II.B step 5 + the Fig. 5
memory-over-time analysis).

A ``Schedule`` is an ordered list of ``Stage``s.  A stage executes one or
more layers *row-interleaved*; edges listed in ``streamed`` are
layer-fused: the producer's rows are forwarded through register files
('connections between these register files ... make it possible to
consume outputs of a given attention head layer immediately as input of
a next layer', Sec. IV.B.1) and never occupy L1 feature memory.  A
streamed edge may also *cross* stages when producer and consumer run on
different cores: the rows are then forwarded over the platform's
interconnect instead of a register file (declared on the consumer
stage; see ``core/engine.py``).

This module is the stable facade over three composable pieces:

* ``core/costmodel.py`` — per-node latency/energy (``CostModel``
  protocol; the analytical model is the default implementation);
* ``core/interconnect.py`` — the link/NoC model cross-core transfers
  are booked on;
* ``core/engine.py``     — the event-driven executor that schedules all
  stages' nodes against global time with per-(core, resource) ready
  queues.

``evaluate`` keeps its seed signature and, for single-core schedules,
its bit-exact seed results (pinned by tests/test_core_engine.py).

Memory accounting (the paper's 'total active features memory'):

* a node's output rows become active at its completion, unless the whole
  tensor is streamed to its (sole) consumers;
* a tensor row is freed when the last consumer node needing it completes
  (row-range liveness from dependencies.consumer_row_counts);
* network outputs stay active (the dot at the end of Fig. 5's plots);
* weights are not feature data and are not tracked;
* a tensor consumed on a different core than it was produced on is
  double-buffered: the replica occupies the consumer's L1 from its
  arrival over the link until the last consumer node on that core
  completes, while the home copy follows row liveness as before;
* KV-cache appends (``Workload.cache_layers``, decode phase) are
  persistent memory, not active features: never allocated in L1 and
  reported separately as ``Result.kv_cache_words``;
* on multi-block networks (``Workload.block_of``), a core switching
  blocks refills its weight memory off-chip —
  ``Result.weight_reload_words/cycles`` (zero on single-block
  workloads, which stay bit-identical to the seed).

Accounting granularity (matches the paper's Fig. 5 bookkeeping exactly):
row-range frees (substitutions — 'one row of the left input matrix can
be discarded and substituted by one row of the output matrix') are
atomic with the completing node's allocation; whole-tensor (ALL-region)
lifetimes end at the consuming layer's completion boundary ('whereafter
the K^T matrix can be discarded'), i.e. *after* the peak at that instant
is recorded.

A copy of the JAX package's ``repro/core/scheduler.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import nodes as cn
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import Accelerator
from repro_torch.core.costmodel import CostModel, IllegalSchedule  # noqa: F401

__all__ = [
    "IllegalSchedule", "Stage", "Schedule", "Result", "layer_by_layer",
    "evaluate",
]


@dataclasses.dataclass(frozen=True)
class Stage:
    """Row-interleaved execution of ``layers`` on core ``core``.

    ``streamed`` holds (producer, consumer) layer-name pairs fused through
    register files.  The consumer must be in this stage; the producer is
    either also in this stage (classic intra-stage fusion, producer
    first) or scheduled by another stage on a *different* core — a
    cross-core streamed edge forwarded over the interconnect.
    """

    layers: tuple[str, ...]
    streamed: frozenset[tuple[str, str]] = frozenset()
    core: int = 0

    def __post_init__(self):
        for a, b in self.streamed:
            if b not in self.layers:
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}): consumer not inside stage "
                    f"{self.layers}")
            if a not in self.layers:
                continue    # cross-stage edge: engine validates the rest
            if self.layers.index(a) >= self.layers.index(b):
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}) must go forward in the stage")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An ordered tuple of :class:`Stage` — the unit ``evaluate``
    executes.  Stage order is per-core program order (cores progress
    concurrently); see docs/schedule_format.md for the format and the
    invariants ``validation.validate_schedule`` checks."""

    name: str
    stages: tuple[Stage, ...]

    def streamed_pairs(self) -> frozenset[tuple[str, str]]:
        out: set[tuple[str, str]] = set()
        for st in self.stages:
            out |= set(st.streamed)
        return frozenset(out)


def layer_by_layer(workload: wl.Workload, core: int = 0,
                   order: Optional[list[str]] = None) -> Schedule:
    """The baseline schedule: one stage per layer, topological order (or a
    caller-supplied legal order)."""
    names = order or [l.name for l in workload.topo_order()]
    stages = tuple(
        Stage(layers=(n,), core=core) for n in names
        if cn.split_layer(workload.layers[n])  # skip view transposes
    )
    return Schedule(name="layer-by-layer", stages=stages)


#: Bytes per feature word across the DSE engine (16-bit activations).
#: All ``Result`` counters are in *words*; multiply by this to get
#: bytes (the convention is documented once in docs/architecture.md).
WORD_BYTES = 2


def _kib(words: int) -> str:
    """Human-readable byte rendering of a word count (2 B/word),
    scaled to KiB / MiB / GiB."""
    size = words * WORD_BYTES / 1024
    for unit in ("KiB", "MiB"):
        if size < 1024:
            return f"{size:.1f} {unit}"
        size /= 1024
    return f"{size:.1f} GiB"


@dataclasses.dataclass
class Result:
    """Evaluation of one (workload, accelerator, schedule) triple.

    Units: latencies in cycles (``latency_mcycles`` for 1e6 cycles),
    energies in pJ, memory in words (2 B/word, see ``WORD_BYTES``).
    """

    schedule: str
    latency_cycles: float
    energy_pj: float
    energy_scaled_pj: float      # with sqrt-capacity SRAM energy scaling
    peak_active_words: int       # max over time, summed over cores
    per_core_peak: dict
    trace: list                  # [(cycle, total_active_words)]
    macs: int
    vector_ops: int
    # communication accounting (zero for single-core schedules)
    comm_cycles: float = 0.0     # total link busy cycles
    comm_energy_pj: float = 0.0  # included in energy_pj as well
    link_utilization: dict = dataclasses.field(default_factory=dict)
    # phase-aware accounting (zero for single-block prefill workloads)
    kv_cache_words: int = 0          # persistent KV-cache footprint,
    #                                  NOT part of peak_active_words
    weight_reload_words: int = 0     # weights re-fetched off-chip when
    #                                  a core switched network blocks
    weight_reload_cycles: float = 0.0

    @property
    def latency_mcycles(self) -> float:
        return self.latency_cycles / 1e6

    def __repr__(self) -> str:
        extra = ""
        if self.comm_cycles:
            extra += f", comm={self.comm_cycles / 1e6:.3f} Mcycles"
        if self.kv_cache_words:
            extra += f", kv_cache={_kib(self.kv_cache_words)}"
        if self.weight_reload_words:
            extra += f", reload={_kib(self.weight_reload_words)}"
        return (f"Result({self.schedule!r}, "
                f"latency={self.latency_mcycles:.3f} Mcycles, "
                f"energy={self.energy_pj / 1e6:.3f} uJ, "
                f"peak_active={self.peak_active_words} words "
                f"({_kib(self.peak_active_words)}){extra})")


def _streamed_tensors(workload: wl.Workload,
                      schedule: Schedule) -> set[str]:
    """Tensors that never hit L1: every consumer reads them through a
    streamed edge, and they are not workload outputs."""
    from repro_torch.core import dependencies as deps
    pairs = schedule.streamed_pairs()
    out = set()
    for layer in workload.layers.values():
        # view consumers followed to their consumers (K -> KT -> QKT)
        consumers = deps.real_consumers(workload, layer.name)
        if not consumers:
            continue
        if layer.name in workload.outputs:
            continue
        if all((layer.name, c) in pairs for c in consumers):
            out.add(layer.name)
    return out


def evaluate(workload: wl.Workload, accel: Accelerator, schedule: Schedule,
             row_block: int = 1,
             cost_model: Optional[CostModel] = None) -> Result:
    """Execute ``schedule`` on the analytical machine model.

    Thin facade over the event-driven executor in ``core/engine.py``;
    ``cost_model`` defaults to the analytical ``costmodel.DEFAULT``.

    Args:
        workload:  the layer DAG to execute.
        accel:     platform description (cores, memories, links).
        row_block: node granularity in output rows (1 = the paper's
                   finest split; peaks are granularity-invariant for
                   these layer types).

    Returns a :class:`Result` (cycles / pJ / words — see the units
    table in docs/architecture.md).  Raises ``IllegalSchedule`` on
    Step-2 or platform violations.
    """
    from repro_torch.core import engine
    return engine.execute(workload, accel, schedule, row_block=row_block,
                          cost_model=cost_model)
