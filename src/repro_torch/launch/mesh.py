"""Meshes of the port: a copy of ``repro/launch/mesh.py`` over
``torch.distributed`` ranks, and the helper that starts them.

A :class:`Mesh` names its axes and their sizes, the running rank's
coordinates, one process group per axis of more than one rank (the
ranks that share every other coordinate) and the rank's device.  Ranks
are laid out row-major over the shape, as JAX lays devices out in
``make_mesh``, and ``Mesh.devices`` is that array of ranks, so code that
reads ``dict(zip(mesh.axis_names, mesh.devices.shape))`` reads either
mesh.

Single pod: (data=16, model=16).  Multi-pod: (pod=2, data=16, model=16);
the "pod" axis is the outermost data axis.  Both production meshes are
shapes only (no processes): the dry-run resolves shard shapes on them.

The backend and each rank's device are the caller's to name: two gloo
ranks on one ``cuda:0`` is what a single card allows (NCCL refuses two
ranks on one device), as JAX's tests force host devices.  Nothing here
switches backends by itself.

:func:`fake_world` makes the running process rank 0 of a process group
of any size whose collectives return at once without moving data
(PyTorch's ``fake`` backend): with meta tensors, one process runs rank
0's program of a production mesh (the dry-run's cost count).  It is the
one place that imports the private ``fake_pg`` module; run it in a
child process (:func:`in_child`), so no fake group outlives the count.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Named axes over ranks 0..size-1, row-major; ``rank`` is the
    running process's place on it, ``groups`` its process group per
    axis of more than one rank, ``device`` its device."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], *,
                 rank: int = 0, groups: Optional[dict] = None,
                 device=None):
        if len(axis_names) != len(shape):
            raise ValueError(f"axes {axis_names} against shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        self.rank = int(rank)
        self.groups = dict(groups or {})
        self.device = torch.device(device) if device is not None else None
        self.devices = np.arange(self.size).reshape(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords_of(self, rank: int) -> dict:
        """{axis: coordinate} of ``rank``."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(rank, self.shape))))

    @property
    def coords(self) -> dict:
        return self.coords_of(self.rank)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of ``axis`` (of more than one rank)."""
        if axis not in self.groups:
            raise RuntimeError(
                f"mesh {dict(zip(self.axis_names, self.shape))} has no "
                f"process group for axis {axis!r}: a shape-only mesh "
                "runs no collective")
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}, device={self.device})")


def _world() -> tuple:
    """(rank, world size) of the running process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_over_ranks(shape: Sequence[int], axes: Sequence[str],
                    device=None) -> Mesh:
    """A mesh over every rank of the running process group (a mesh of
    one rank needs none).  Every rank must call it, in the same order
    as its other group creations: ``new_group`` is collective."""
    rank, world = _world()
    size = math.prod(shape)
    if size == 1:
        return Mesh(axes, shape, rank=0, device=device)
    if size != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} "
                         f"ranks; the process group has {world}")
    grid = np.arange(size).reshape(shape)
    groups = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        # the ranks that share every coordinate but axis i's, one group
        # per such line, created in the same order on every rank
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(axes, shape, rank=rank, groups=groups, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape (no processes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over the running ranks, clamped to their
    count as JAX's clamps to its devices.  (1, 1) is this rank alone."""
    _, n = _world()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return mesh_over_ranks((data, model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _result_path(init_file: str, rank: int) -> str:
    return f"{init_file}.rank{rank}.pt"


def _rank_main(rank: int, world: int, fn: Callable, backend: str,
               devices: Sequence[str], init_file: str, args: tuple,
               threads: int, timeout_s: float) -> None:
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, device, *args)
        torch.save(out, _result_path(init_file, rank))
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn: Callable, *, backend: str,
          devices: Sequence[str], init_file: str, args: tuple = (),
          timeout: float = 600.0, threads: int = 1) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` fresh processes
    (``torch.multiprocessing`` spawn), joined into one ``backend``
    process group through ``init_file`` (``file://``, which must not be
    in use).  ``devices[rank]`` is rank's device; each rank runs
    ``threads`` CPU threads.  ``fn`` must be importable (a module-level
    function).  Returns each rank's return value (saved with
    ``torch.save``, so tensors come back on their device).  Joins within
    ``timeout`` seconds or kills the ranks and raises TimeoutError; a
    rank that raises ends the run, and its exception is raised here."""
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices: {devices}")
    init_file = os.path.abspath(init_file)
    for path in [init_file] + [_result_path(init_file, r)
                               for r in range(world)]:
        if os.path.exists(path):
            os.remove(path)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, fn, backend, list(devices), init_file,
                          tuple(args), threads, timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks of {fn.__qualname__} did not finish "
                    f"within {timeout:.0f}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        path = _result_path(init_file, r)
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    return out


# ---------------------------------------------------------------------------
# a fake world: rank 0 of a mesh of any size in one process
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """The running process as rank 0 of a ``size``-rank process group of
    PyTorch's ``fake`` backend (collectives return at once and move no
    data), destroyed on exit.  Raises if a process group is running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _child_main(fn: Callable, args: tuple, queue) -> None:
    torch.set_num_threads(1)
    try:
        queue.put(("ok", fn(*args)))
    except BaseException as e:          # the parent raises it
        queue.put(("error", f"{type(e).__name__}: {e}"))


def in_child(fn: Callable, *args, timeout: float = 1200.0):
    """``fn(*args)`` in a fresh (spawned) process, one CPU thread, and
    its return value (picklable); an exception there is raised here as
    RuntimeError.  ``fn`` must be importable.  Kills the child after
    ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_child_main, args=(fn, args, queue))
    proc.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                status, out = queue.get(timeout=1.0)
                break
            except queue_mod.Empty:
                if not proc.is_alive():
                    raise RuntimeError(
                        f"{fn.__qualname__}: its child process died "
                        f"(exit code {proc.exitcode})") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{fn.__qualname__} did not finish within "
                        f"{timeout:.0f}s in its child process") from None
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if status != "ok":
        raise RuntimeError(f"{fn.__qualname__} in its child process: {out}")
    return out
