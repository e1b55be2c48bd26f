"""Deterministic fault injection and the structured incident ledger: a
copy of ``repro/serve/faults.py`` over the port's ``OutOfPages`` and
``KernelLaunchError``, whose messages and ledger rows it keeps word for
word, so the two packages' ledgers compare as strings.  A spec's
``impl`` defaults to ``cuda``, the port's kernel impl, where the JAX
package's defaults to ``pallas``.

Chaos engineering for the serving stack: the paper's schedule
optimisation deliberately runs the paged engine close to page-pool
exhaustion, which leaves no slack when something breaks mid-stream —
so breakage has to be a *first-class, reproducible* input.  A
:class:`FaultInjector` carries a schedule of :class:`FaultSpec` entries
and is consulted from three hook points:

* ``PageAllocator.alloc``/``ensure`` (``on_alloc``) — raises
  :class:`~repro_torch.serve.engine.OutOfPages` on the armed step,
  modelling pool exhaustion at admission, resume, or the in-step page
  grow;
* ``kernels.ops`` dispatch resolution (``on_kernel``, installed via
  ``ops.set_fault_injector``) — raises
  :class:`~repro_torch.kernels.ops.KernelLaunchError` when the resolved
  impl matches the armed spec, modelling a sick kernel the supervisor must
  rung-down around;
* the engine's decode step (``nan_slot``) — poisons one live slot's
  logits/last-token, modelling numerics corruption the supervisor must
  quarantine; plus ``preempt_storm`` — forced preemptions of healthy
  slots, modelling external pressure.

Everything is keyed on the scheduler step (``begin_step``), never on
wall-clock, so the same seed replays the same faults — and the same
:class:`IncidentLedger` — run after run.  Determinism per seed is a
gate of ``tests/test_torch_chaos.py`` and of the chaos phase of
``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Optional

from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.serve.engine import OutOfPages

__all__ = ["FaultSpec", "FaultInjector", "Incident", "IncidentLedger"]

#: fault kinds a spec may carry
KINDS = ("oom", "kernel", "nan", "preempt")

#: incident kinds whose occurrence depends on wall-clock (watchdog
#: timings) — excluded from the deterministic ledger serialisation
TIMING_KINDS = ("stuck_step",)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``kind``:  'oom' (raise OutOfPages from the allocator), 'kernel'
               (raise KernelLaunchError at dispatch), 'nan' (poison
               ``slot``'s logits after the decode launch), 'preempt'
               (force-preempt ``count`` healthy slots).
    ``step``:  the scheduler step it arms on.
    ``slot``:  the nan target row (nan only).
    ``impl``:  kernel faults fire only when the resolved impl matches
               (so a rung-down to a different impl genuinely escapes
               the fault — a sick CUDA kernel does not poison the
               plain versions or the reference).
    ``times``: how many raises the spec yields on its step (None =
               every consultation that step; 1 = fail once then let
               the retry through).
    ``count``: preemption-storm size (preempt only).
    """
    kind: str
    step: int
    slot: Optional[int] = None
    impl: str = "cuda"
    times: Optional[int] = 1
    count: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")


class FaultInjector:
    """Replays a :class:`FaultSpec` schedule against the hook points.

    The injector is stateful per step: ``begin_step(t)`` arms the
    specs scheduled for ``t`` and resets their per-step raise
    budgets.  Every fault actually fired is appended to ``fired`` —
    `(step, kind, detail)` tuples — which tests compare across runs
    to assert schedule determinism.
    """

    def __init__(self, schedule: list):
        self.schedule = list(schedule)
        self.fired: list = []
        self._step = -1
        self._armed: list = []

    # ------------------------------------------------------------ arming
    def begin_step(self, t: int) -> None:
        """Arm the specs scheduled for step ``t`` (fresh raise
        budgets)."""
        self._step = t
        self._armed = [[s, s.times] for s in self.schedule
                       if s.step == t]

    def _take(self, kind: str, match=None) -> Optional[FaultSpec]:
        for entry in self._armed:
            spec, left = entry
            if spec.kind != kind or (left is not None and left <= 0):
                continue
            if match is not None and not match(spec):
                continue
            if left is not None:
                entry[1] = left - 1
            return spec
        return None

    # ------------------------------------------------------- hook points
    def on_alloc(self, key, n: int) -> None:
        """PageAllocator.alloc/ensure hook: raise on the armed step."""
        spec = self._take("oom")
        if spec is not None:
            self.fired.append((self._step, "oom",
                               f"alloc({key!r}, {n})"))
            raise OutOfPages(
                f"injected page exhaustion at step {self._step} "
                f"(alloc({key!r}, {n}))")

    def on_kernel(self, entry: str, impl: str) -> None:
        """kernels.ops dispatch hook: raise when the resolved impl
        matches the armed spec."""
        spec = self._take("kernel", lambda s: s.impl == impl)
        if spec is not None:
            self.fired.append((self._step, "kernel",
                               f"{entry}/{impl}"))
            raise KernelLaunchError(
                f"injected kernel launch failure at step "
                f"{self._step} ({entry}, impl={impl!r})")

    def nan_slot(self) -> Optional[int]:
        """Engine decode hook: the slot whose logits to poison this
        step (None = no nan fault armed)."""
        spec = self._take("nan")
        if spec is None:
            return None
        self.fired.append((self._step, "nan", f"slot {spec.slot}"))
        return spec.slot

    def preempt_storm(self) -> int:
        """Supervisor hook: how many healthy slots to force-preempt
        this step (0 = no storm armed)."""
        spec = self._take("preempt")
        if spec is None:
            return 0
        self.fired.append((self._step, "preempt",
                           f"storm of {spec.count}"))
        return spec.count

    # ------------------------------------------------------ constructors
    @classmethod
    def from_seed(cls, seed: int, *, steps: int, slots: int,
                  kinds=KINDS, rate: float = 0.15,
                  impl: str = "cuda") -> "FaultInjector":
        """A reproducible random schedule: each step draws at most one
        fault with probability ``rate``, its kind/slot drawn from the
        same stream.  Same seed, same schedule, the same draws as the
        JAX package's for the same arguments."""
        rng = random.Random(seed)
        schedule = []
        for t in range(steps):
            if rng.random() >= rate:
                continue
            kind = kinds[rng.randrange(len(kinds))]
            schedule.append(FaultSpec(
                kind=kind, step=t,
                slot=rng.randrange(slots) if kind == "nan" else None,
                impl=impl, times=1,
                count=1 + rng.randrange(2) if kind == "preempt" else 1))
        return cls(schedule)


@dataclasses.dataclass
class Incident:
    """One ledger row: what broke, where, what the supervisor did
    about it, and how it ended."""
    step: int
    slot: Optional[int]
    fault: str                  # oom | kernel | nan | preempt | ...
    action: str                 # what the supervisor did
    outcome: str                # recovered | requeued | deferred | ...
    detail: str = ""


class IncidentLedger:
    """The structured incident record threading through the
    supervisor.  ``to_json`` is the deterministic serialisation the
    chaos tests compare across runs and with the JAX package's:
    incidents whose *occurrence* depends on wall-clock
    (``TIMING_KINDS``, e.g. the stuck-step watchdog) are excluded unless
    ``include_timing``."""

    def __init__(self):
        self.incidents: list = []

    def record(self, step: int, slot: Optional[int], fault: str,
               action: str, outcome: str, detail: str = "") -> None:
        self.incidents.append(
            Incident(step, slot, fault, action, outcome, detail))

    def counts(self) -> dict:
        out: dict = {}
        for inc in self.incidents:
            out[inc.fault] = out.get(inc.fault, 0) + 1
        return out

    def rows(self, include_timing: bool = False) -> list:
        return [dataclasses.asdict(i) for i in self.incidents
                if include_timing or i.fault not in TIMING_KINDS]

    def to_json(self, include_timing: bool = False) -> str:
        return json.dumps(self.rows(include_timing), sort_keys=True)

    def __len__(self) -> int:
        return len(self.incidents)

    def __repr__(self) -> str:
        return f"<IncidentLedger {self.counts()}>"
