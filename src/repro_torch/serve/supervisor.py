"""Page-pressure relief for the paged engine: the victim policy of
``repro/serve/supervisor.py:63-114``, which ``RequestBatcher.serve``
delegates to.  The rest of the JAX supervisor (fault-tolerant driving,
the incident ledger the JAX policy also reports to, snapshots) is not
ported yet."""

from __future__ import annotations

__all__ = ["PagePressurePolicy"]


class PagePressurePolicy:
    """Victim selection under page pressure.

    ``victim``: 'newest' (least sunk work, the default), 'oldest'
    (frees starving requests under adversarial streams), or 'largest'
    (most pages back per preemption).  ``keep_last`` guards the
    lone-request invariant: a single live request must run (or raise
    OutOfPages honestly), never preempt itself into a live-lock.
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

    def relieve(self, engine, batcher) -> list:
        """Preempt victims until the next decode step fits the free
        page list; preempted requests rejoin the queue front with their
        snapshot on ``req.paused``.  Returns the preempted slots."""
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
        return preempted
