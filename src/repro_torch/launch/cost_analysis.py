"""The cost counter of the port: what ``compiled.cost_analysis()`` and
the HLO's collective operands give the JAX package's dry-run, counted
from the ops a program runs instead of from a compiled module.

Inside :func:`count` three sums run over everything the process does:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
  ops (matmul-like ops only: norms, softmax and elementwise ops add
  none), plus each hand-written kernel's closed form
  (``kernels/cost.py``), which its wrapper or plain version reports
  whichever of the two runs;
* **bytes accessed**: each aten op's input and output bytes, view and
  alias ops (every return an alias its schema marks read-only),
  uninitialised allocations and the collectives' own ops (the third
  sum) left out; an indexed read (``x[idx]``, ``gather``) counts the
  elements it fetches, not all of ``x``, and an indexed write in place
  (``x[idx] = v``, ``scatter_``) the indices and values it reads and the
  values it writes, not all of ``x`` (a decode step's one new cache
  column); inside a kernel call only the kernel's closed form, which
  keeps its intermediates on chip;
* **collective bytes**: the per-device output bytes of every
  ``torch.distributed`` call of ``sharding/collectives.py``, under
  JAX's HLO op names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``) and their ``total``, in the
  dtype the call moves: a 16-bit reduction in fp32, a gather or an
  all-to-all as raw bytes.  FSDP's reduce-scatter is an all-reduce and
  this rank's slice, so it counts under ``all-reduce``; the residual
  stream's sequence reduce-scatter (``seq_stream``) is one, and counts
  under ``reduce-scatter``.

It runs on any device: on the card (the kernels launched), on the CPU,
and on the ``meta`` device, where nothing is computed and a program
runs at any size in seconds.  Under ``launch.mesh.fake_world`` the
collectives of a mesh of any size return at once, so one process
counts rank 0's program of a production cell (``launch/dryrun.py``).
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import cost

#: the collective ops by JAX's HLO names (``launch/dryrun.py``'s keys)
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


#: indexed reads: the output's elements are what they read of ``self``
_GATHERS = {"index", "index_select", "gather", "embedding"}
#: indexed writes in place: they write their last tensor argument's
#: elements into ``self``
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
             "scatter_add_", "scatter_reduce_", "index_add_"}


def _moves_nothing(func) -> bool:
    """Whether ``func`` moves no tensor data of its own: a view or alias
    (every return aliases an input, read-only), an allocation left
    uninitialised, or a collective (counted as one)."""
    namespace, name = func._schema.name.split("::")
    if namespace != "aten":
        return True
    if name == "_unsafe_view":          # a view its schema does not mark
        return True
    returns = func._schema.returns
    if returns and all(r.alias_info is not None and not r.alias_info.is_write
                       for r in returns):
        return True
    return name.startswith("empty")


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes ``func`` reads and writes (:func:`_moves_nothing` ops
    excluded by the caller)."""
    name = func._schema.name.split("::")[1]
    rest = [x for x in _pytree.tree_leaves((args[1:], kwargs))
            if isinstance(x, torch.Tensor)]
    if name in _GATHERS:
        return sum(map(_nbytes, rest)) + 2 * sum(
            map(_nbytes, _pytree.tree_leaves(out)))
    if name in _SCATTERS:
        return sum(map(_nbytes, rest)) + (_nbytes(rest[-1]) if rest else 0)
    return sum(_nbytes(x) for x in _pytree.tree_leaves((args, kwargs, out)))


class Counter:
    """The three sums of one :func:`count`; read them with
    :meth:`result`."""

    def __init__(self, flops: FlopCounterMode):
        self._flops = flops
        #: inside a kernel call (its own ops are the kernel's)
        self.in_kernel = False
        self.kernel_flops = 0
        self.excluded_flops = 0         # aten FLOPs inside kernel calls
        self.bytes_accessed = 0
        self.collectives = dict.fromkeys(OPS, 0)
        #: kernel name -> calls counted
        self.kernels: collections.Counter = collections.Counter()

    def collective(self, op: str, nbytes: int) -> None:
        self.collectives[op] += int(nbytes)

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """One kernel call of ``flops`` operations and ``nbytes`` bytes;
        the aten ops inside it count nothing."""
        before = self._flops.get_total_flops()
        self.in_kernel = True
        try:
            yield
        finally:
            self.in_kernel = False
            self.excluded_flops += self._flops.get_total_flops() - before
        self.kernel_flops += int(flops)
        self.bytes_accessed += int(nbytes)
        self.kernels[name] += 1

    def result(self) -> dict:
        """{"flops", "bytes_accessed", "collective_bytes": {op: bytes,
        ..., "total"}, "kernels": {name: calls}}."""
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {"flops": self._flops.get_total_flops()
                - self.excluded_flops + self.kernel_flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": coll,
                "kernels": dict(self.kernels)}


class CollectiveCounter:
    """The collective bytes alone (no FLOPs, no bytes accessed, each
    kernel call left to run uncounted): cheap enough to run around a
    timed program on the card.  Read them with :meth:`result`."""

    in_kernel = False

    def __init__(self):
        self.collectives = dict.fromkeys(OPS, 0)

    def collective(self, op: str, nbytes: int) -> None:
        self.collectives[op] += int(nbytes)

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        yield

    def result(self) -> dict:
        """{"collective_bytes": {op: bytes, ..., "total"}}."""
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {"collective_bytes": coll}


@contextlib.contextmanager
def count_collectives():
    """Count the collective bytes of the enclosed code alone; yields the
    :class:`CollectiveCounter`.  Not reentrant, nor inside
    :func:`count`."""
    counter = CollectiveCounter()
    cost.set_counter(counter)
    try:
        yield counter
    finally:
        cost.set_counter(None)


class _BytesMode(TorchDispatchMode):
    """Sums each aten op's input and output bytes into a Counter."""

    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.counter.in_kernel and not _moves_nothing(func):
            self.counter.bytes_accessed += _op_bytes(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def count():
    """Count what the enclosed code runs; yields the :class:`Counter`
    (read ``result()`` after the block).  Not reentrant."""
    flops = FlopCounterMode(display=False)
    counter = Counter(flops)
    cost.set_counter(counter)
    try:
        with _BytesMode(counter), flops:
            yield counter
    finally:
        cost.set_counter(None)
