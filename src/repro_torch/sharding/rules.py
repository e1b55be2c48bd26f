"""Logical-axis sharding of the port: a copy of the JAX package's
``repro/sharding/rules.py`` rule logic, in plain Python.

Every tensor of the model is annotated with logical axis names (the
parameters' by :func:`repro_torch.models.weights.param_axes`); the rules
map them onto mesh axes.  Parallelism on the production mesh (pod,
data, model):

* DP/FSDP -- activations' "batch" over (pod, data); parameters' "embed"
  over "data";
* TP      -- "heads"/"kv_heads"/"mlp"/"vocab" over "model";
* EP      -- "experts" over "model";
* SP      -- "seq" optionally over "model" (:data:`RULES_SEQ_PARALLEL`);
* pod     -- the outermost data axis.

A tensor dim whose rule resolves to a mesh axis another dim of the same
tensor already took falls back to None (replication): the first dim
wins, as flax's logical partitioning does.

A ``PartitionSpec`` is a plain tuple here, one entry per dim: None, a
mesh axis name, or a tuple of mesh axis names (major first).
:func:`shard_shape` and :func:`local_slice` take the place of JAX's
``NamedSharding``: the shape of one rank's block and that block.

The port has no partitioner.  Under a data mesh the training state
lies in blocks, as JAX lays it out: each rank holds its block of every
parameter, gradient, AdamW moment and error-feedback buffer under
:func:`param_shardings`' specs over the data axes (FSDP, ZeRO-3:
``sharding/fsdp.py``), and a layer gathers its weights when it runs.
Under a mesh with ``head_parallel_decode`` or ``distributed_decode``
set, the serving state lies in blocks too: the weights under
:func:`param_shardings`' whole specs and the decode caches by role
(``serve/layout.py``), and the model runs on the
blocks.  A mesh with neither flag serves the whole state on every
rank.
JAX's ``constrain`` (``with_sharding_constraint``) is a layout hint
without a numeric effect, so it has no counterpart here but one: the
residual stream's ``("batch", "seq_stream", "embed_act")``, which
decides what a rank holds between the blocks and which collectives
move it (:func:`stream_splits`; ``models/transformer.py``).  Under
``dict(DEFAULT_RULES, seq_stream=None)`` the stream stays whole.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Sequence

import torch

from repro_torch import tree

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": "model",        # decode caches: time dim sharded over TP
    "seq_stream": "model",    # the residual stream between blocks
    "tokens": ("pod", "data", "model"),
    "tokens_out": ("pod", "data"),
    "embed": ("pod", "data"),  # FSDP (ZeRO-3) shard of parameters
    "embed_act": None,        # activations' feature dim replicated
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_embed": ("pod", "data"),
    "expert_mlp": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "latent": None,
    "inner": "model",
}

RULES_SEQ_PARALLEL = dict(DEFAULT_RULES, seq="model", heads=None,
                          kv_heads=None, inner=None, ssm_heads=None)

_state = threading.local()


def _current() -> tuple:
    """(the active mesh or None, the active rules)."""
    return (getattr(_state, "mesh", None),
            getattr(_state, "rules", DEFAULT_RULES))


def active_mesh():
    """The mesh :func:`set_rules_for_mesh` activated, or None."""
    return _current()[0]


#: the mesh axes a batch's rows lie over, outermost first
DATA_AXES = ("pod", "data")


def data_axes(mesh=None) -> tuple:
    """The data axes of ``mesh`` (default: the active one) that span
    more than one rank; () without a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES
                 if a in mesh.axis_names and mesh.axis_size(a) > 1)


@contextlib.contextmanager
def set_rules_for_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh and a rule set for this thread.  Inside, a config
    with ``distributed_decode``, ``head_parallel_decode``,
    ``moe_local_dispatch`` or ``moe_shard_map_ep`` takes its mesh path;
    without a mesh those flags are inert."""
    prev = _current()
    _state.mesh = mesh
    _state.rules = rules or DEFAULT_RULES
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def under_active_rules(fn):
    """``fn`` bound to the mesh and rules active now: it runs under them
    wherever it is called.  A checkpointed layer's recompute needs it:
    the autograd engine runs a CUDA graph's backward, and the recompute
    with it, in a thread of its own, where this thread's rules are
    unset (a CPU graph's runs in the calling thread)."""
    mesh, rules = _current()
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with set_rules_for_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return run


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of any mesh with ``axis_names`` and a
    ``devices`` array (the port's Mesh, or JAX's)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_mesh_axes(logical: Sequence[Optional[str]],
                         rules: Optional[dict] = None, mesh=None,
                         shape: Optional[Sequence[int]] = None) -> tuple:
    """Resolve logical axes to a spec, dropping duplicate mesh axes
    (first dim wins), axes absent from the mesh, and, when ``shape`` is
    given, axes that do not evenly divide the dimension (they fall back
    to replication, e.g. a 40-head tensor on a 16-way model axis)."""
    rules = rules if rules is not None else _current()[1]
    mesh = mesh if mesh is not None else _current()[0]
    mesh_axes = mesh_sizes(mesh) if mesh is not None else None
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        ax = rules.get(name) if name is not None else None
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        picked = []
        size = shape[i] if shape is not None else None
        for a in axes:
            if mesh_axes is not None and a not in mesh_axes:
                continue
            if a in used:
                continue
            if size is not None:
                factor = mesh_axes[a] if mesh_axes else 1
                prior = 1
                for p in picked:
                    prior *= mesh_axes[p]
                if size % (prior * factor) != 0:
                    continue
            used.add(a)
            picked.append(a)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


#: the residual stream's logical axes, JAX's ``constrain`` of the
#: embedding's output and of each layer's
STREAM = ("batch", "seq_stream", "embed_act")


def stream_spec(shape: Sequence[int], rules: Optional[dict] = None,
                mesh=None) -> tuple:
    """The spec of a residual stream of global ``shape`` (B, S, E)
    under the active (or given) rules and mesh: :data:`STREAM` resolved
    on the shape, as JAX's shape-aware ``constrain`` resolves it (an S
    that does not divide the model axis stays whole)."""
    return logical_to_mesh_axes(STREAM, rules, mesh, shape=shape)


def stream_splits(shape: Sequence[int], mesh=None) -> bool:
    """Whether the active rules hold a residual stream of global
    ``shape`` as sequence blocks over a "model" axis of more than one
    rank of ``mesh`` (default: the active one)."""
    mesh = mesh if mesh is not None else active_mesh()
    return splits(stream_spec(shape, mesh=mesh), 1, mesh)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def splits(spec: Optional[tuple], dim: int, mesh,
           axis: str = "model") -> bool:
    """Whether ``spec`` lays dim ``dim`` out over ``axis`` of more than
    one rank of ``mesh`` (False for a None spec or mesh)."""
    return spec is not None and mesh is not None \
        and axis in spec_axes(spec[dim]) and mesh.axis_size(axis) > 1


def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor laid out by
    ``spec`` on ``mesh``.  Raises ValueError where a dim does not
    divide, as ``shard_map`` and ``device_put`` do."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = math.prod(sizes[a] for a in spec_axes(entry))
        if dim % n:
            raise ValueError(f"dim {i} of shape {tuple(shape)} does not "
                             f"divide over {entry!r} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def block_index(entry, mesh, coords: dict) -> tuple:
    """(index, count) of a rank's block along a dim laid out by spec
    ``entry``: the mesh axes' coordinates, major first."""
    sizes = mesh_sizes(mesh)
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_slice(x: torch.Tensor, spec: tuple, mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s block (default: the mesh's own rank) of the
    global tensor ``x`` laid out by ``spec`` on ``mesh``: a view."""
    coords = mesh.coords_of(mesh.rank if rank is None else rank)
    shard_shape(x.shape, spec, mesh)      # raises where a dim does not divide
    for i, entry in enumerate(spec):
        idx, n = block_index(entry, mesh, coords)
        if n > 1:
            step = x.shape[i] // n
            x = x.narrow(i, idx * step, step)
    return x


class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``, without devices):
    what ``CheckpointManager.restore(shardings=)`` and
    ``runtime.elastic.remesh_state`` slice a leaf by.  A leaf of the
    port's trees (not a dataclass, which ``tree`` would descend)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_sizes(self.mesh)}, {self.spec})"

    def shard_shape(self, shape) -> tuple:
        return shard_shape(shape, self.spec, self.mesh)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x``."""
        return local_slice(x, self.spec, self.mesh)


def sharded_axes(sharding: Optional[NamedSharding]) -> tuple:
    """The mesh axes of more than one rank that ``sharding`` splits its
    leaf over (() for None or a whole leaf)."""
    if sharding is None:
        return ()
    return tuple(a for e in sharding.spec for a in spec_axes(e)
                 if sharding.mesh.axis_size(a) > 1)


def logical_sharding(logical: Sequence[Optional[str]], mesh=None,
                     rules: Optional[dict] = None) -> NamedSharding:
    mesh = mesh if mesh is not None else _current()[0]
    if mesh is None:
        raise ValueError("no active mesh")
    return NamedSharding(mesh, logical_to_mesh_axes(logical, rules, mesh))


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names."""
    return isinstance(x, tuple)


def param_shardings(param_axes, mesh=None, rules: Optional[dict] = None,
                    like=None):
    """A tree of logical-axis tuples as a tree of :class:`NamedSharding`.
    ``like`` (a tree of tensors of the same structure) turns on the
    divisibility-aware fallback."""
    mesh = mesh if mesh is not None else _current()[0]
    if like is None:
        return tree.map(lambda axes: logical_sharding(axes, mesh, rules),
                        param_axes, is_leaf=is_axes)
    return tree.map(
        lambda axes, x: NamedSharding(mesh, logical_to_mesh_axes(
            axes, rules, mesh, shape=x.shape)),
        param_axes, like, is_leaf=is_axes)
