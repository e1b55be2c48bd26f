"""Admission-controlled request scheduler for the continuous-batching
engines, dense and paged (host-side serving loop); a copy of
``repro/serve/batcher.py``.

Slots of a fixed decode batch are leased to requests as they arrive
and reclaimed when a row finishes (EOS or budget): ``serve`` drives a
``ContinuousBatchingEngine`` — new requests are prefilled on the side
and inserted into free rows while the other rows keep decoding, and
every step is ONE whole-batch launch whose per-row ``cache_len`` /
``lengths`` let the masked kernels skip each row's dead KV blocks.
The per-slot dispatch is real per-row compute, carried by the
engine's per-slot state.  Straggler note: at multi-host scale the
batcher runs on host 0 and broadcasts slot assignments with the token
batch — decode steps stay SPMD.

Admission rules:

* FIFO fairness — queued requests are admitted strictly in submit
  order as slots free up; a long queued prompt is never jumped by a
  later short one.
* ``max_concurrency`` budgets how many slots may be live at once
  (<= batch_size), bounding the per-step KV traffic independently of
  the allocated batch geometry.
* ``max_len`` bounds the cache: prompts that cannot fit (no room for
  even one new token) are rejected at ``submit``; a prompt of exactly
  ``max_len - 1`` tokens is admitted with its generation budget
  clamped to 1.  Budgets are always clamped so prompt + generated
  never overruns a cache row.

Paged engines (``engine.allocator`` present) add two rules:

* admission is by free-*page* budget, not just free slots — the queue
  head is admitted only when the pool can hold its prompt plus one
  decoded token, and the lease reserves those pages on the spot so
  back-to-back admissions each see the true remaining pool (strict
  FIFO: an oversized head blocks, it is never jumped);
* under page pressure (a live row about to cross a page boundary with
  the free list empty) the *newest* lease is preempted — its KV pages
  snapshot to host memory and return to the pool — and the request
  rejoins the queue front, resuming bit-identically once pages free
  up.  The newest lease has the least sunk work, and front-of-queue
  re-admission preserves FIFO order among the preempted.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_new_tokens: int = 32
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # a PreemptedRequest snapshot while the request sits re-queued
    # after preemption (None otherwise): the next lease resumes it
    # instead of re-prefilling
    paused: object = None
    # supervisor bookkeeping: quarantine re-admissions consumed so far
    # and whether the request was failed (deadline / retry budget
    # exhausted) — failed requests are reported, never silently dropped
    retries: int = 0
    failed: bool = False


class RequestBatcher:
    def __init__(self, batch_size: int, eos_id: int = -1,
                 max_len: Optional[int] = None,
                 max_concurrency: Optional[int] = None):
        self.batch_size = batch_size
        self.eos_id = eos_id
        self.max_len = max_len
        self.max_concurrency = batch_size if max_concurrency is None \
            else min(max_concurrency, batch_size)
        self.queue: deque = deque()
        self.slots: list = [None] * batch_size
        self.slot_lens: list = [0] * batch_size   # prompt + generated
        self.finished: list = []

    def submit(self, req: Request) -> None:
        """Queue a request.  Legal while ``run``/``serve`` is
        mid-flight (the next admission pass picks it up).  With
        ``max_len`` set, a prompt that cannot fit the cache alongside
        at least one new token is rejected; the generation budget is
        clamped to the cache headroom (a ``max_len - 1`` prompt is
        admitted with budget 1).  Prompts are validated here — empty
        or non-integer token arrays fail fast with a ``ValueError``
        instead of a shape error deep inside prefill — and normalised
        to a plain list of ints."""
        toks = np.asarray(req.prompt)
        if toks.ndim != 1:
            raise ValueError(
                f"request {req.uid}: prompt must be a 1-D token "
                f"sequence, got shape {toks.shape}")
        if toks.size == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt — nothing to prefill")
        if not np.issubdtype(toks.dtype, np.integer):
            raise ValueError(
                f"request {req.uid}: prompt tokens must be integers, "
                f"got dtype {toks.dtype}")
        req.prompt = [int(t) for t in toks]
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be >= 1, "
                f"got {req.max_new_tokens}")
        if self.max_len is not None:
            if len(req.prompt) >= self.max_len:
                raise ValueError(
                    f"request {req.uid}: prompt length {len(req.prompt)} "
                    f">= max_len {self.max_len} leaves no room to decode")
            req.max_new_tokens = min(req.max_new_tokens,
                                     self.max_len - len(req.prompt))
        self.queue.append(req)

    def _n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit_one(self, can_admit: Optional[Callable] = None
                   ) -> Optional[int]:
        """Admit the queue *head* into the lowest free slot (or return
        None).  ``can_admit(req)`` — the paged engine's free-page check
        — gates the head: a head that cannot be admitted blocks the
        queue, strict FIFO, no jumping.  One request at a time so the
        caller can take its page reservation before the next head is
        checked against the (then-smaller) free list."""
        if not self.queue or self._n_active() >= self.max_concurrency:
            return None
        if can_admit is not None and not can_admit(self.queue[0]):
            return None
        for i in range(self.batch_size):
            if self.slots[i] is None:
                req = self.queue.popleft()
                self.slots[i] = req
                self.slot_lens[i] = len(req.prompt) + len(req.generated)
                return i
        return None

    def _fill_slots(self, can_admit: Optional[Callable] = None) -> list:
        """Admit queued requests into free slots, FIFO, stopping at the
        ``max_concurrency`` budget.  Returns the newly leased slots."""
        newly = []
        while True:
            i = self._admit_one(can_admit)
            if i is None:
                break
            newly.append(i)
        return newly

    @property
    def active(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.queue)

    def step(self, next_tokens: np.ndarray) -> None:
        """Feed back one decoded token per slot."""
        self.step_slots([i for i, s in enumerate(self.slots)
                         if s is not None],
                        [next_tokens[i] for i, s in enumerate(self.slots)
                         if s is not None])

    def step_slots(self, slot_ids: list, tokens) -> list:
        """Feed back one decoded token for each slot in ``slot_ids``
        (other slots untouched).  Returns the slots that finished."""
        freed = []
        for i, tok in zip(slot_ids, tokens):
            req = self.slots[i]
            if req is None:
                continue
            tok = int(tok)
            req.generated.append(tok)
            self.slot_lens[i] += 1
            if tok == self.eos_id or \
                    len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self.slot_lens[i] = 0
                freed.append(i)
        return freed

    def run(self, prefill_fn: Callable, decode_fn: Callable,
            max_steps: int = 1000) -> list:
        """Drive a callback loop: prefill_fn(slot_ids, prompts) seeds
        caches, decode_fn() -> (B,) next tokens advances every active
        row in one whole-batch step.  (Per-slot kernel work is the
        engine's per-row state — see ``serve`` — not a scheduler
        concern.)"""
        steps = 0
        while self.active and steps < max_steps:
            new_slots = self._fill_slots()
            if new_slots:
                prefill_fn(new_slots,
                           [self.slots[i].prompt for i in new_slots])
            self.step(np.asarray(decode_fn()))
            steps += 1
        return self.finished

    def _relieve_page_pressure(self, engine) -> list:
        """Preempt leases until the next decode step fits the free
        page list, delegated to the default (newest-victim)
        :class:`~repro_torch.serve.supervisor.PagePressurePolicy`.
        Returns the preempted slots."""
        from repro_torch.serve.supervisor import PagePressurePolicy
        return PagePressurePolicy().relieve(engine, self)

    def serve(self, engine, max_steps: int = 1000) -> list:
        """Drive a :class:`~repro_torch.serve.engine.ContinuousBatchingEngine`
        to completion (or ``max_steps``): admit queued requests into
        free engine slots (FIFO, budgeted), let the engine prefill and
        insert them mid-stream, feed decoded tokens back per slot, and
        evict rows the moment they finish so the next request can take
        the slot — the decode loop never stops for admission.

        A paged engine (``engine.allocator``) adds page-budget
        admission, preempt-newest under page pressure, and snapshot
        resume (no prefill recompute) when a preempted request is
        re-leased."""
        paged = getattr(engine, "allocator", None) is not None
        can_admit = None
        if paged:
            def can_admit(req):
                if req.paused is not None:
                    return engine.can_resume(req.paused)
                return engine.can_admit_tokens(len(req.prompt))
        steps = 0
        while (self.active or engine._pending) and steps < max_steps:
            # lease-and-reserve one request at a time: the engine's
            # begin_prefill/resume takes its pages before the next
            # head is checked against the remaining free list
            while True:
                slot = self._admit_one(can_admit)
                if slot is None:
                    break
                req = self.slots[slot]
                if req.paused is not None:
                    engine.resume(req.paused, slot)
                    req.paused = None
                else:
                    engine.begin_prefill(slot, req.prompt)
            if paged:
                self._relieve_page_pressure(engine)
            tokens, inserted = engine.step()
            # a request's first token is sampled by its prefill
            for slot, first in inserted:
                for f in self.step_slots([slot], [first]):
                    engine.evict(f)
            if tokens is not None:
                ready = [i for i in range(self.batch_size)
                         if engine.live[i] and self.slots[i] is not None]
                for f in self.step_slots(ready, tokens[ready]):
                    engine.evict(f)
            steps += 1
        return self.finished
