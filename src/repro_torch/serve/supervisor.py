"""The serving supervisor, a port of ``repro/serve/supervisor.py``: the
fault-tolerant serving loop of both engines, and the page-pressure
policy ``RequestBatcher.serve`` delegates to.

:class:`ServingSupervisor` wraps a
:class:`~repro_torch.serve.engine.ContinuousBatchingEngine` (dense or
paged) and a :class:`~repro_torch.serve.batcher.RequestBatcher` and runs
the same admission -> prefill -> decode -> feed loop as
``batcher.serve``, but every transition is guarded, every recovery is
an explicit policy, and everything that goes wrong lands on a
structured :class:`~repro_torch.serve.faults.IncidentLedger`:

* **Kernel failures** (:class:`~repro_torch.kernels.ops.KernelLaunchError`,
  raised only by an installed fault injector) recover by *rung-down*:
  the engine's standing ``demotions`` count is raised and the step
  retried one rung lower on the lowering ladder (``decode_megakernel ->
  qproj_attention -> fused_attention -> unfused/reference ->
  unfused/torch``), each step recorded on the plan's downgrade ledger
  by :func:`~repro_torch.lower.runtime.rung_down`.  After ``cooloff``
  clean steps the demotion decays, so a transient fault drifts back to
  the planned path.  Nothing else is caught: a kernel that fails to
  build or launch, or a wrapper that refuses a shape, ends the run.
* **NaN/Inf logits** quarantine only the poisoned slot: its row is
  rolled back to the last clean (context, token), preempted to a host
  snapshot and requeued at the queue front, and the rest of the batch
  advances untouched.  A per-request ``retry_budget`` bounds the loop;
  exhaustion fails the request visibly (ledger and the request's
  ``failed`` flag), never silently.  A config with Mamba-2 layers
  refuses the rollback (``ContinuousBatchingEngine.rollback_slot``).
* **Page exhaustion** (:class:`~repro_torch.serve.engine.OutOfPages`),
  from admission, the in-step page grow or injection, is relieved
  through the :class:`PagePressurePolicy` and retried; admission
  failures requeue the head and defer.
* **Preemption storms** (injected) preempt healthy rows through the
  same snapshot/resume path the pressure policy uses.
* **Stuck steps**: an optional
  :class:`~repro_torch.runtime.elastic.StepTimer` watchdog flags steps
  k x over the running median on the ledger (timing incidents are left
  out of the deterministic ledger serialisation).
* **Crash safety**: with a ``CheckpointManager`` attached, the whole
  serving state (device state, allocator, batcher queue, supervisor
  counters) snapshots every ``checkpoint_every`` steps through
  ``serve/snapshot.py``; ``ServingSupervisor.restore`` resumes the
  stream bit for bit.
* **Auditing**: ``audit_every=n`` runs the
  :func:`~repro_torch.serve.audit.audit_engine` invariant checker every
  n steps and raises on the first violation: recovery that corrupts
  state is a bug, not a recovery.

The ledger's rows are the JAX supervisor's, word for word.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.serve.audit import audit_engine
from repro_torch.serve.engine import OutOfPages
from repro_torch.serve.faults import IncidentLedger
from repro_torch.serve.snapshot import restore_engine, snapshot_engine

__all__ = ["PagePressurePolicy", "ServingSupervisor"]


class PagePressurePolicy:
    """Victim selection under page pressure.

    ``victim``: 'newest' (least sunk work, the default), 'oldest'
    (starvation-freeing under adversarial streams), or 'largest' (most
    pages back per preemption).
    ``keep_last`` guards the lone-request invariant: a single live
    request must run (or honestly raise OutOfPages), never preempt
    itself into a live-lock.
    """

    def __init__(self, victim: str = "newest", keep_last: int = 1):
        if victim not in ("newest", "oldest", "largest"):
            raise ValueError(f"unknown victim policy {victim!r}")
        self.victim = victim
        self.keep_last = keep_last

    def pick(self, engine, live: list) -> int:
        if self.victim == "newest":
            return max(live, key=lambda i: engine.lease_order[i])
        if self.victim == "oldest":
            return min(live, key=lambda i: engine.lease_order[i])
        return max(live, key=lambda i: len(
            engine.allocator.pages.get(i, [])))

    def relieve(self, engine, batcher, ledger=None,
                step: Optional[int] = None) -> list:
        """Preempt victims until the next decode step fits the free
        page list; preempted requests rejoin the queue *front* with
        their snapshot on ``req.paused``, each preemption a
        ``page_pressure`` row on ``ledger`` when one is given.  Returns
        the preempted slots."""
        preempted = []
        while engine.step_page_deficit() > 0:
            live = [i for i in range(batcher.batch_size)
                    if batcher.slots[i] is not None and engine.live[i]]
            if len(live) <= self.keep_last:
                break
            victim = self.pick(engine, live)
            req = batcher.slots[victim]
            req.paused = engine.preempt(victim)
            batcher.slots[victim] = None
            batcher.slot_lens[victim] = 0
            batcher.queue.appendleft(req)
            preempted.append(victim)
            if ledger is not None:
                ledger.record(
                    step if step is not None else -1, victim,
                    "page_pressure", f"preempt ({self.victim} victim)",
                    "requeued", f"request {req.uid} at ctx "
                    f"{req.paused.length}")
        return preempted


class ServingSupervisor:
    """Drive ``engine`` + ``batcher`` to completion under faults.

    Parameters beyond the obvious: ``injector`` (a
    :class:`~repro_torch.serve.faults.FaultInjector`, installed on the
    engine, its allocator and the kernels-dispatch hook for the run),
    ``deadline_steps`` (fail a request leased longer than this many
    scheduler steps; None = no deadline), ``retry_budget`` (quarantine
    re-admissions per request), ``max_step_retries`` (launch retries
    within one step before giving up), ``cooloff`` (clean steps before
    one demotion level decays; None = demotions are sticky),
    ``watchdog`` (a StepTimer), ``ckpt``/``checkpoint_every`` (crash-
    safe snapshots), ``audit_every`` (invariant checks).
    """

    def __init__(self, engine, batcher, *, injector=None,
                 ledger: Optional[IncidentLedger] = None,
                 pressure: Optional[PagePressurePolicy] = None,
                 deadline_steps: Optional[int] = None,
                 retry_budget: int = 3, max_step_retries: int = 8,
                 cooloff: Optional[int] = 4, watchdog=None,
                 ckpt=None, checkpoint_every: Optional[int] = None,
                 audit_every: Optional[int] = None):
        self.engine = engine
        self.batcher = batcher
        self.injector = injector
        self.ledger = ledger if ledger is not None else IncidentLedger()
        self.pressure = pressure or PagePressurePolicy()
        self.deadline_steps = deadline_steps
        self.retry_budget = retry_budget
        self.max_step_retries = max_step_retries
        self.cooloff = cooloff
        self.watchdog = watchdog
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.audit_every = audit_every
        self.paged = getattr(engine, "allocator", None) is not None
        self.t = 0
        self.lease_step: dict = {}      # uid -> step first leased
        self.failed: list = []          # requests failed, not dropped
        self._clean_steps = 0
        self._last_kernel = True
        self._pre_ctx = list(engine.row_ctx)
        self._pre_tok = engine.last_tokens().tolist()

    # ------------------------------------------------------------ plumbing
    def _attach(self):
        if self.injector is not None:
            self.engine.fault_injector = self.injector
            if self.paged:
                self.engine.allocator.fault_injector = self.injector
            ops.set_fault_injector(self.injector)

    def _detach(self):
        self.engine.fault_injector = None
        if self.paged:
            self.engine.allocator.fault_injector = None
        ops.set_fault_injector(None)

    def state_dict(self) -> dict:
        return {"t": self.t,
                "lease_step": {str(k): v
                               for k, v in self.lease_step.items()},
                "demotions": self.engine.demotions,
                "clean_steps": self._clean_steps}

    def load_state_dict(self, sd: dict) -> None:
        self.t = sd["t"]
        self.lease_step = {int(k): v
                           for k, v in sd["lease_step"].items()}
        self.engine.demotions = sd["demotions"]
        self._clean_steps = sd["clean_steps"]

    def checkpoint(self, blocking: bool = True) -> None:
        """Crash-safe whole-engine snapshot at the current step."""
        if self.ckpt is None:
            raise ValueError("no CheckpointManager attached")
        snapshot_engine(self.ckpt, self.t, self.engine, self.batcher,
                        supervisor=self, blocking=blocking)

    def restore(self, step: Optional[int] = None) -> None:
        """Resume from the latest (or ``step``) snapshot: device
        state, allocator, batcher queue and supervisor counters all
        return to the snapshotted scheduler step; the continuation is
        bit-identical to the uncrashed run."""
        if self.ckpt is None:
            raise ValueError("no CheckpointManager attached")
        restore_engine(self.ckpt, self.engine, self.batcher,
                       step=step, supervisor=self)

    # ------------------------------------------------------------- phases
    def _admit(self) -> None:
        can_admit = None
        if self.paged:
            def can_admit(req):
                if req.paused is not None:
                    return self.engine.can_resume(req.paused)
                return self.engine.can_admit_tokens(len(req.prompt))
        while True:
            slot = self.batcher._admit_one(can_admit)
            if slot is None:
                return
            req = self.batcher.slots[slot]
            try:
                if req.paused is not None:
                    self.engine.resume(req.paused, slot)
                    req.paused = None
                else:
                    self.engine.begin_prefill(slot, req.prompt)
                self.lease_step.setdefault(req.uid, self.t)
            except OutOfPages as e:
                # the lease never took (alloc is all-or-nothing, and
                # begin_prefill rolls its pending entry back): un-admit
                # and defer the head to a later, calmer step
                self.batcher.slots[slot] = None
                self.batcher.slot_lens[slot] = 0
                self.batcher.queue.appendleft(req)
                self.ledger.record(self.t, slot, "oom",
                                   "admission deferred", "requeued",
                                   str(e))
                return

    def _storm(self) -> None:
        if self.injector is None:
            return
        n = self.injector.preempt_storm()
        live = [i for i in range(self.batcher.batch_size)
                if self.batcher.slots[i] is not None
                and self.engine.live[i]]
        live.sort(key=lambda i: -self.engine.lease_order[i]
                  if self.paged else -i)
        for victim in live[:n]:
            req = self.batcher.slots[victim]
            req.paused = self.engine.preempt(victim)
            self.batcher.slots[victim] = None
            self.batcher.slot_lens[victim] = 0
            self.batcher.queue.appendleft(req)
            self.ledger.record(self.t, victim, "preempt",
                               "storm preemption", "requeued",
                               f"request {req.uid} at ctx "
                               f"{req.paused.length}")

    def _launch(self, fn, what: str):
        """Run a launch-shaped phase with rung-down/relief retries."""
        attempts = 0
        while True:
            try:
                out = fn()
                if attempts:
                    self.ledger.record(
                        self.t, None, "kernel" if self._last_kernel
                        else "oom", f"{what} retry succeeded",
                        "recovered",
                        f"demotion level {self.engine.demotions}")
                return out
            except KernelLaunchError as e:
                attempts += 1
                self._last_kernel = True
                self.engine.demotions += 1
                self.ledger.record(
                    self.t, None, "kernel",
                    f"rung-down to demotion level "
                    f"{self.engine.demotions}", "retrying", str(e))
                if attempts > self.max_step_retries:
                    self.ledger.record(self.t, None, "kernel",
                                       "retries exhausted", "fatal",
                                       str(e))
                    raise
            except OutOfPages as e:
                attempts += 1
                self._last_kernel = False
                self.ledger.record(self.t, None, "oom",
                                   "page-pressure relief", "retrying",
                                   str(e))
                if self.paged:
                    self.pressure.relieve(self.engine, self.batcher,
                                          self.ledger, self.t)
                if attempts > self.max_step_retries:
                    self.ledger.record(self.t, None, "oom",
                                       "retries exhausted", "fatal",
                                       str(e))
                    raise

    def _quarantine(self) -> list:
        """Detect NaN/Inf logits and quarantine the poisoned slots:
        roll each back to its pre-step (context, token), preempt the
        row to a host snapshot and requeue it at the queue front.  The
        rest of the batch is untouched."""
        logits = self.engine.last_logits
        if logits is None:
            return []
        bad = torch.nonzero(~torch.isfinite(logits).all(dim=-1))
        quarantined = []
        for slot in bad.flatten().tolist():
            req = self.batcher.slots[slot]
            if req is None or not self.engine.live[slot]:
                continue
            self.engine.rollback_slot(slot, self._pre_ctx[slot],
                                      self._pre_tok[slot])
            req.retries += 1
            pre = self.engine.preempt(slot)
            self.batcher.slots[slot] = None
            self.batcher.slot_lens[slot] = 0
            if req.retries > self.retry_budget:
                req.failed = True
                req.done = True
                self.failed.append(req)
                self.lease_step.pop(req.uid, None)
                self.ledger.record(
                    self.t, slot, "nan", "quarantine",
                    "failed (retry budget exhausted)",
                    f"request {req.uid} after {req.retries} retries")
            else:
                req.paused = pre
                self.batcher.queue.appendleft(req)
                self.ledger.record(
                    self.t, slot, "nan",
                    "quarantine: rollback + preempt", "requeued",
                    f"request {req.uid} rolled back to ctx "
                    f"{self._pre_ctx[slot]}")
            quarantined.append(slot)
        return quarantined

    def _deadlines(self) -> None:
        if self.deadline_steps is None:
            return
        for i, req in enumerate(self.batcher.slots):
            if req is None:
                continue
            leased = self.lease_step.get(req.uid, self.t)
            if self.t - leased < self.deadline_steps:
                continue
            if i in self.engine._pending:
                # cancel an in-flight prefill: drop the side cache and
                # give its page reservation back
                del self.engine._pending[i]
                if self.paged:
                    self.engine.allocator.release(i)
            elif self.engine.live[i]:
                self.engine.evict(i)
            self.batcher.slots[i] = None
            self.batcher.slot_lens[i] = 0
            req.failed = True
            req.done = True
            self.failed.append(req)
            self.lease_step.pop(req.uid, None)
            self.ledger.record(
                self.t, i, "deadline", "evicted",
                "failed (deadline exceeded)",
                f"request {req.uid} leased at step {leased}")

    # --------------------------------------------------------------- loop
    def step(self) -> None:
        """One supervised scheduler step."""
        if self.injector is not None:
            self.injector.begin_step(self.t)
        if self.watchdog is not None:
            self.watchdog.start()
        had_incidents = len(self.ledger)
        self._admit()
        self._storm()
        if self.paged:
            self.pressure.relieve(self.engine, self.batcher,
                                  self.ledger, self.t)
        inserted = self._launch(self.engine._advance_prefills,
                                "prefill")
        # pre-step rollback anchors for the quarantine path
        self._pre_ctx = list(self.engine.row_ctx)
        self._pre_tok = self.engine.last_tokens().tolist()
        tokens = self._launch(self.engine.decode_once, "decode")
        # a request's first token is sampled by its prefill: clean by
        # construction, so feed it before the quarantine pass (which
        # may unlease the slot) can get between it and the request
        for slot, first in inserted:
            for f in self.batcher.step_slots([slot], [first]):
                self.engine.evict(f)
        quarantined = set(self._quarantine())
        if tokens is not None:
            ready = [i for i in range(self.batcher.batch_size)
                     if self.engine.live[i]
                     and self.batcher.slots[i] is not None
                     and i not in quarantined]
            for f in self.batcher.step_slots(ready, tokens[ready]):
                self.engine.evict(f)
        self._deadlines()
        if len(self.ledger) == had_incidents:
            self._clean_steps += 1
            if self.cooloff is not None and self.engine.demotions \
                    and self._clean_steps >= self.cooloff:
                self.engine.demotions -= 1
                self._clean_steps = 0
                self.ledger.record(
                    self.t, None, "cooloff",
                    f"demotion decayed to {self.engine.demotions}",
                    "recovered", f"{self.cooloff} clean steps")
        else:
            self._clean_steps = 0
        if self.audit_every and self.t % self.audit_every == 0:
            bad = audit_engine(self.engine, self.batcher)
            if bad:
                raise AssertionError(
                    f"audit violations at step {self.t}: {bad}")
        if self.watchdog is not None and self.watchdog.stop():
            self.ledger.record(self.t, None, "stuck_step",
                               "watchdog flagged straggler", "noted",
                               f"median {self.watchdog.median:.4f}s")
        self.t += 1
        if self.ckpt is not None and self.checkpoint_every and \
                self.t % self.checkpoint_every == 0:
            self.checkpoint()

    def serve(self, max_steps: int = 1000) -> list:
        """Run to completion (or ``max_steps``); returns the batcher's
        finished list.  Failed requests (deadline / retry budget) are
        on ``self.failed`` and the ledger — never silently dropped."""
        self._attach()
        self._last_kernel = True
        try:
            steps = 0
            while (self.batcher.active or self.engine._pending) and \
                    steps < max_steps:
                self.step()
                steps += 1
        finally:
            self._detach()
        return self.batcher.finished
