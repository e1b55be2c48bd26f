"""Fault tolerance for training: a copy of ``StepTimer`` and
``run_with_restarts`` from ``repro/runtime/elastic.py``.  The
multi-device half there (``remesh_state``, ``ElasticRunner``) waits for
the port's multi-device slice.

* ``run_with_restarts`` -- the restart harness: a training loop that may
  raise (node failure, preemption) is re-entered from the latest
  checkpoint and the resumable data step.  The contract: every piece of
  mutable state is (checkpoint tree, data step), nothing else.
* ``StepTimer`` -- straggler detection: a robust step-time envelope;
  a step over k x median is flagged.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class StepTimer:
    def __init__(self, k: float = 3.0, window: int = 50):
        self.k = k
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Returns True if this step is a straggler."""
        dt = time.monotonic() - self._t0
        is_straggler = False
        if len(self.times) >= 5:
            med = float(np.median(self.times[-self.window:]))
            is_straggler = dt > self.k * med
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def run_with_restarts(
    make_step: Callable[[], Callable],
    init_state: Callable[[], Any],
    ckpt: CheckpointManager, *,
    total_steps: int,
    checkpoint_every: int = 10,
    max_restarts: int = 5,
    on_step: Optional[Callable] = None,
) -> tuple[Any, dict]:
    """Crash-tolerant training driver.

    make_step() -> step_fn(state, step_idx) -> state (may raise).
    Any exception triggers restore-from-latest + replay; the data
    pipeline is derived from the step index, so restarts are exact.
    """
    stats = {"restarts": 0, "steps_run": 0}
    state = init_state()
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, extras = ckpt.restore(state)
        start = extras.get("next_step", latest + 1)

    step_fn = make_step()
    step = start
    while step < total_steps:
        try:
            state = step_fn(state, step)
            stats["steps_run"] += 1
            if on_step is not None:
                on_step(step, state)
            if (step + 1) % checkpoint_every == 0 or \
                    step + 1 == total_steps:
                ckpt.save(step, state, extras={"next_step": step + 1},
                          blocking=True)
            step += 1
        except Exception:
            stats["restarts"] += 1
            if stats["restarts"] > max_restarts:
                raise
            latest = ckpt.latest_step()
            state = init_state()
            if latest is not None:
                state, extras = ckpt.restore(state)
                step = extras.get("next_step", latest + 1)
            else:
                step = 0
            step_fn = make_step()
    return state, stats
