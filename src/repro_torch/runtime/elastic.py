"""Fault tolerance and elasticity for training: a copy of
``repro/runtime/elastic.py``.

* ``run_with_restarts`` -- the restart harness: a training loop that may
  raise (node failure, preemption) is re-entered from the latest
  checkpoint and the resumable data step.  The contract: every piece of
  mutable state is (checkpoint tree, data step), nothing else.
* ``remesh_state`` -- elastic re-scaling: a state laid out on one mesh
  re-laid onto another (2 ranks -> 1 after losing one, say).  The specs
  come from the same logical rules on both meshes, so growing or
  shrinking is a gather and a slice, not a code change.
* ``StepTimer`` -- straggler detection: a robust step-time envelope;
  a step over k x median is flagged.
* ``ElasticRunner`` -- restores the latest checkpoint onto whatever
  mesh its factory builds after a restart.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.sharding import logical_to_mesh_axes, param_shardings
from repro_torch.sharding.collectives import gather_spec
from repro_torch.sharding.rules import is_axes, local_slice


def remesh_state(state: Any, axes: Any, new_mesh, rules=None, *,
                 mesh=None) -> Any:
    """Re-lay ``state`` (whose leaves carry the logical ``axes``, a tree
    of the same structure with axis-name tuples for leaves) onto
    ``new_mesh``: each leaf gathered from ``mesh``'s ranks (its leaves
    are this rank's blocks under the rules' specs there; None: they are
    global) to the host, then this rank's block of it on ``new_mesh``
    taken, on ``new_mesh.device`` (or the leaf's device).  Host-gathers
    then re-slices: the simple, always-correct path.  Every rank of
    ``mesh`` must call it (the gather is collective)."""
    def place(ax, x):
        if mesh is not None:
            x = gather_spec(x, logical_to_mesh_axes(ax, rules, mesh), mesh)
        full = x.detach().cpu()
        spec = logical_to_mesh_axes(ax, rules, new_mesh)
        dev = new_mesh.device if new_mesh.device is not None else x.device
        return local_slice(full, spec, new_mesh).contiguous().to(dev)

    return tree.map(place, axes, state, is_leaf=is_axes)


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


class ElasticRunner:
    """Failure-aware wrapper that re-meshes when the rank set changes
    between restarts (a test passes another mesh factory after a
    "failure")."""

    def __init__(self, ckpt: CheckpointManager, axes: Any,
                 mesh_factory: Callable, rules=None):
        self.ckpt = ckpt
        self.axes = axes
        self.mesh_factory = mesh_factory
        self.rules = rules

    def restore_on_current_mesh(self, like_state: Any):
        """(state, extras, mesh): the latest checkpoint, each leaf this
        rank's block on the factory's mesh."""
        mesh = self.mesh_factory()
        shardings = param_shardings(self.axes, mesh, self.rules)
        state, extras = self.ckpt.restore(like_state, shardings=shardings)
        return state, extras, mesh
