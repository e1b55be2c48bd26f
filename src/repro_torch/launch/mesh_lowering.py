"""Lowering a DSE head->core allocation onto a mesh of ranks: a copy of
``repro/launch/mesh_lowering.py`` over the port's own DSE core.

The heterogeneous GA (``core/allocation.optimize_allocation``) decides
which core runs which attention head; the engine prices the resulting
cross-core traffic (partial-output transfers and the input broadcast)
as ``Result.comm_cycles``.  This module closes the loop: a 2-core DSE
schedule becomes a 2-rank head-parallel serve.

* ``mesh_for_cores(n)`` builds a (data=1, model=n) mesh over the running
  ranks, one mesh column per DSE core;
* ``lower_to_mesh(plan, accel, allocation)`` wraps an
  ``ExecutionPlan`` into a :class:`MeshLoweredPlan` whose ``activate()``
  makes the serving stack route decode attention through
  ``serve.distributed_decode.head_parallel_decode_attention``;
* ``predicted_comm_seconds`` converts the engine's predicted
  ``comm_cycles`` at ``accel.frequency_hz`` into seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import allocation as galloc
from repro_torch.core import scheduler as sch
from repro_torch.core.accelerator import Accelerator
from repro_torch.launch.mesh import _world, mesh_over_ranks
from repro_torch.lower.plan import ExecutionPlan
from repro_torch.sharding import rules as shrules

__all__ = ["mesh_for_cores", "MeshLoweredPlan", "lower_to_mesh"]


def mesh_for_cores(n_cores: int, *, data: int = 1, device=None):
    """A (data, model=n_cores) mesh with one model column per DSE core.

    Raises ValueError when fewer than ``data * n_cores`` ranks run (the
    tests start them with ``launch.mesh.spawn``): a silent clamp would
    break the core<->rank correspondence the lowering promises."""
    need = data * n_cores
    have = _world()[1]
    if have < need:
        raise ValueError(
            f"mesh_for_cores({n_cores}, data={data}) needs {need} "
            f"devices, the process group has {have} ranks (start them "
            f"with launch.mesh.spawn({need}, ...))")
    return mesh_over_ranks((data, n_cores), ("data", "model"),
                           device=device)


@dataclasses.dataclass
class MeshLoweredPlan:
    """An ExecutionPlan bound to a mesh under a head->core allocation.

    ``predict()`` evaluates the head-partitioned analytical schedule
    (``allocation.head_partition_schedule``) on the DSE platform, not
    the plan's own single-core source schedule, so its ``comm_cycles``
    prices the traffic the lowered serve pays: one (M x d_model) partial
    per non-root core plus the input broadcast.  ``activate()`` returns
    the sharding-rules context under which the serving stack takes the
    head-parallel decode path."""

    plan: ExecutionPlan
    accel: Accelerator
    allocation: tuple
    mesh: object
    d_model: int
    axis: str = "model"
    softmax_allocation: Optional[tuple] = None
    _predicted: Optional[sch.Result] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_heads(self) -> int:
        return len(self.allocation)

    def predict(self, row_block: Optional[int] = None) -> sch.Result:
        if self._predicted is not None and row_block is None:
            return self._predicted
        workload, schedule = galloc.head_partition_schedule(
            self.plan.M, self.d_model, self.n_heads, self.plan.head_dim,
            tuple(self.allocation),
            sm_allocation=self.softmax_allocation)
        if row_block is None:
            row_block = max(1, self.plan.M // 64)
        res = sch.evaluate(workload, self.accel, schedule,
                           row_block=row_block)
        if row_block == max(1, self.plan.M // 64):
            self._predicted = res
        return res

    @property
    def predicted_comm_cycles(self) -> float:
        return self.predict().comm_cycles

    @property
    def predicted_comm_seconds(self) -> float:
        """Engine link-busy cycles at the platform clock."""
        return self.predict().comm_cycles / self.accel.frequency_hz

    def activate(self):
        """The context activating the mesh for the serving stack
        (``sharding.rules.set_rules_for_mesh``): inside, a config with
        ``head_parallel_decode=True`` routes decode attention through
        the head-partitioned body."""
        return shrules.set_rules_for_mesh(self.mesh)

    def describe(self) -> str:
        lines = [
            f"MeshLoweredPlan[{self.plan.config_name} {self.plan.phase} "
            f"M={self.plan.M} N={self.plan.head_dim} "
            f"d_model={self.d_model}]",
            f"  allocation: head->core {tuple(self.allocation)}"
            + (f" softmax->{tuple(self.softmax_allocation)}"
               if self.softmax_allocation is not None else ""),
            f"  mesh: {shrules.mesh_sizes(self.mesh)}"
            f" over axis {self.axis!r}",
            f"  predicted comm: {self.predicted_comm_cycles:.0f} cycles"
            f" = {self.predicted_comm_seconds * 1e6:.3f} us"
            f" @ {self.accel.frequency_hz / 1e9:g} GHz",
        ]
        return "\n".join(lines)


def lower_to_mesh(plan: ExecutionPlan, accel: Accelerator, allocation, *,
                  d_model: Optional[int] = None, mesh=None,
                  sm_allocation=None,
                  axis: str = "model") -> MeshLoweredPlan:
    """Bind a decode ExecutionPlan and a head->core allocation to a
    mesh.  ``allocation`` maps head -> DSE core; the mesh's ``axis``
    must have one rank per distinct core used (default: a fresh
    ``mesh_for_cores`` over ``accel.n_cores``).  ``d_model`` defaults to
    ``len(allocation) * plan.head_dim``.  The lowering is recorded on
    the plan's note ledger."""
    allocation = tuple(int(c) for c in allocation)
    if not allocation:
        raise ValueError("empty head allocation")
    if any(c < 0 or c >= accel.n_cores for c in allocation):
        raise ValueError(
            f"allocation {allocation} names cores outside "
            f"{accel.name}'s 0..{accel.n_cores - 1}")
    if d_model is None:
        d_model = len(allocation) * plan.head_dim
    if mesh is None:
        mesh = mesh_for_cores(accel.n_cores)
    mesh_shape = shrules.mesh_sizes(mesh)
    if axis not in mesh_shape:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh_shape}")
    n_used = len(set(allocation))
    if mesh_shape[axis] < n_used:
        raise ValueError(
            f"allocation uses {n_used} cores but mesh axis {axis!r} "
            f"has {mesh_shape[axis]} devices")
    lowered = MeshLoweredPlan(
        plan=plan, accel=accel, allocation=allocation, mesh=mesh,
        d_model=d_model, axis=axis, softmax_allocation=sm_allocation)
    plan.note(
        f"lowered to mesh {mesh_shape} over {axis!r}: head->core "
        f"{allocation}, predicted comm "
        f"{lowered.predicted_comm_cycles:.0f} cycles")
    return lowered
