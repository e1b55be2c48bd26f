"""The collectives of the port's multi-device paths, over one process
group per mesh axis, and the ``shard_map`` they run inside.

``psum``, ``pmean``, ``pmax`` and the tiled ``all_to_all`` are thin
``torch.autograd.Function``s with the backward ``jax.grad`` gives
through the same collective inside ``shard_map(check_rep=False)``: the
transpose of ``psum`` is ``psum`` (and of ``pmean`` ``pmean``), that of
an ``all_to_all`` the inverse ``all_to_all``; ``pmax`` has none (JAX
raises "Differentiation rule for 'pmax' not implemented", and so does
this backward).  :func:`gather_spec` and its transpose
:func:`reduce_scatter` are plain functions, which FSDP's differentiable
gather (``sharding/fsdp.py``) and :func:`all_gather` are built from.

Tensor-parallel training (the ``model`` axis, ``train/step.py``) keeps
JAX's ``shard_map`` convention: every rank of the axis computes the
values it holds whole (the residual stream, the norms, the loss), and
the cotangent each rank holds of such a value is its share, the ranks'
shares summing to the cotangent.  The loss enters the backward through
:func:`leave` (each rank's share is 1/n), and a parameter leaf that is
whole on the axis through :func:`enter` (the identity; its backward
sums the shares, Megatron's *f*), so its gradient is the whole one on
every rank.  In between, the model's call sites use ``psum`` (its
backward the ``psum`` of the shares: the exact cotangent of each
rank's partial): the output projections of the attention heads and of
the MLP's hidden block, the embedding's vocabulary rows and the
vocabulary-parallel cross entropy's sums; :func:`all_gather` where a
block becomes whole (the MoE router's expert columns, the experts'
outputs), and ``pmax`` with no gradient for the cross entropy's row
max.  A model-axis block's own gradient is exact on its rank and is
never summed over the axis.

Under JAX's ``seq_stream`` (``rules.stream_splits``: the residual
stream's sequence dim over "model" where it divides) the residual
stream between sublayers is a *sequence block*: each rank holds its
S/n rows, and the norms and residual adds run on them.  A sequence
block's cotangent is exact on its rank, as a model-axis block's is; a
value whole on every rank still carries a share.  Each sublayer takes
its normed input through :func:`seq_gather` (an all-gather along the
sequence; its backward reduce-scatters the ranks' shares of the whole
cotangent, each rank keeping its block's sum) and leaves through
:func:`to_stream`: a partial (the heads', the MLP columns', a
vocabulary block's rows) by :func:`seq_scatter` (a reduce-scatter; its
backward all-gathers the blocks' exact cotangents, the exact cotangent
of every rank's partial), a value every rank holds whole by its rows
(a slice, whose backward pads the block's cotangent with zeros: a
share).  A leaf whole on "model" (a norm's scale) then gets each rank's
part of the gradient from its rows, and ``enter`` sums them, as it
sums the shares.  Megatron's sequence parallelism: the sums of the
model-axis partials become reduce-scatters, the stream's copies
all-gathers.

:func:`shard_map` is JAX's ``shard_map`` over a port mesh, for the
paths whose arguments are global tensors on every rank (activations,
which every rank computes whole, and the training paths' weights).
Each such argument enters the body as this rank's block under its
in-spec; an argument that is already this rank's block (the sharded
serving state's weights, ``sharding/fsdp.py``) enters as it is, under
an in-spec of None.  Each output leaves the body all-gathered over the
axes its out-spec names.  Their backwards are the
transpose rules of JAX's ``shard_map``: an input's cotangent is
gathered over its spec's axes and summed (``psum``) over the mesh axes
its spec leaves out; an output's cotangent is sliced to this rank's
block and divided by the size of the axes its spec leaves out.  Every
rank computes the same loss from replicated outputs, so this gives each
rank the global gradient, as JAX's transpose does.

gloo, the one backend that runs two ranks on one card, takes no CUDA
tensor for ``all_to_all`` and its reductions: under gloo a CUDA
tensor's collective is staged through host memory, logged once per
collective.  :func:`reduce_scatter` (FSDP's) is an all-reduce and this
rank's slice on every backend; the sequence pair runs on
``reduce_scatter_tensor`` and ``all_gather_into_tensor``.  16-bit
floats are reduced in fp32; gathers and all-to-alls move raw bytes.
Each ``torch.distributed`` call reports its per-device output bytes, in
the dtype it moves, to the cost counter (``kernels.cost.collective``;
nothing without an active counter).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import cost
from repro_torch.sharding.rules import local_slice, spec_axes

#: the collectives already logged as staged through the host
_STAGED_LOGGED: set = set()

# torch 2.13 renames ``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` (``*_single``, the old names deprecated);
# torch 2.11 has the old names alone
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` goes through host memory (a CUDA tensor
    under gloo); logs the first such ``op``."""
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if op not in _STAGED_LOGGED:
        _STAGED_LOGGED.add(op)
        print(f"collectives: gloo {op} of CUDA tensors staged through "
              "host memory", flush=True)
    return True


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _all_reduce(t: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    """``op`` all-reduce of ``t`` over ``axes`` (one axis after another,
    a 16-bit ``t`` reduced in fp32 and rounded back after each), a new
    tensor of ``t``'s dtype: on the host where a CUDA tensor is staged,
    else on ``t``'s device."""
    out = t
    for a in _axes(axes):
        if mesh.axis_size(a) == 1:
            continue
        group = mesh.group(a)
        work = out.cpu() if _staged("all_reduce", out, group) else out
        if work.element_size() == 2:
            work = work.float()
        elif work is out:               # the staged copy is new already
            work = work.clone()
        cost.collective("all-reduce", work.numel() * work.element_size())
        dist.all_reduce(work, op=op, group=group)
        out = work.to(t.dtype)
    return out if out is not t else t.clone()


def _reduce(t: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    """``op`` all-reduce of ``t`` over ``axes``, a new tensor of ``t``'s
    dtype and device."""
    return _all_reduce(t, mesh, axes, op).to(t.device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bytes as a flat uint8 tensor: what gloo moves for a
    gather or an all-to-all, whatever the dtype (it takes no 16-bit
    integer, and a copy needs no arithmetic)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim``."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    group = mesh.group(axis)
    staged = _staged("all_gather", x, group)
    src = _bytes(x.cpu() if staged else x)
    parts = [torch.empty_like(src) for _ in range(n)]
    cost.collective("all-gather", n * src.numel())
    dist.all_gather(parts, src, group=group)
    out = torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                    dim=dim)
    return out.to(x.device) if staged else out


def gather_spec(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global tensor of which ``x`` is this rank's block under
    ``spec`` (minor axes first, then major)."""
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            x = _all_gather(x, mesh, a, dim)
    return x


def reduce_scatter(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block under ``spec`` of the sum over the ranks of the
    spec's axes of their ``x`` (global tensors): the transpose of
    :func:`gather_spec`, as an all-reduce and this rank's slice (staged
    through host memory for a CUDA tensor under gloo, the slice alone
    copied back).  Sums in ``x``'s dtype; the callers pass fp32."""
    axes = tuple(a for e in spec for a in spec_axes(e))
    if all(mesh.axis_size(a) == 1 for a in axes):
        return x
    total = _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)
    return local_slice(total, spec, mesh).to(x.device).contiguous()


def _unmentioned(spec: tuple, mesh) -> tuple:
    """The mesh axes of more than one rank that ``spec`` leaves out."""
    named = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a not in named and mesh.axis_size(a) > 1)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        return _reduce(ct, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, None


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, ct):
        raise NotImplementedError(
            "Differentiation rule for 'pmax' not implemented (nor has "
            "JAX one)")


def psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (a name or a tuple of names)."""
    return _Psum.apply(x, mesh, _axes(axis))


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (_reduce(ct, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None,
                None)


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = math.prod(mesh.axis_size(a) for a in axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None, None


def enter(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """A value whole on every rank of ``axis`` entering a computation
    split over it: the identity, whose backward sums the ranks'
    partial cotangents (``psum``): Megatron's *f*, JAX's transpose of a
    replicated operand of a ``model``-split einsum (and of a
    ``shard_map`` input whose spec leaves the axis out)."""
    return _Copy.apply(x, mesh, _axes(axis))


def leave(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """A value every rank of ``axis`` computes whole (a loss) leaving
    a computation split over it: the identity, whose backward hands
    each rank its share, the cotangent over the axis's rank count
    (JAX's transpose of a ``shard_map`` output whose spec leaves the
    axis out), so the shares of every replicated value sum to its
    cotangent."""
    return _Share.apply(x, mesh, _axes(axis))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        out = gather_spec(x, spec, mesh)
        return out if out is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.spec, ctx.mesh), None, None


def all_gather(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """:func:`gather_spec`, differentiable: the backward is its
    transpose, :func:`reduce_scatter` of the ranks' shares of the
    gathered value's cotangent (JAX's transpose of ``all_gather``)."""
    return _AllGather.apply(x, tuple(spec), mesh)


def _seq_all_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The "model" ranks' blocks of ``x`` concatenated along ``dim`` in
    rank order: ``all_gather_into_tensor`` of the raw bytes with ``dim``
    moved first, the moves on ``x``'s device (a CUDA tensor under gloo
    is staged through host memory as contiguous bytes alone)."""
    n = mesh.axis_size("model")
    group = mesh.group("model")
    src = x.movedim(dim, 0).contiguous()
    raw = src.view(-1).view(torch.uint8)
    staged = _staged("all_gather_into_tensor", x, group)
    if staged:
        raw = raw.cpu()
    out = raw.new_empty(n * raw.numel())
    cost.collective("all-gather", out.numel())
    with cost.inside_collective():
        _ALL_GATHER(out, raw, group=group)
    if staged:
        out = out.to(x.device)
    out = out.view(x.dtype).view(n * src.shape[0], *src.shape[1:])
    return out.movedim(0, dim).contiguous()


def _seq_reduce_scatter(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the "model" ranks' sum of
    their ``x``: ``reduce_scatter_tensor`` with ``dim`` moved first, a
    16-bit ``x`` summed in fp32 and rounded back, the moves and casts on
    ``x``'s device (a CUDA tensor under gloo is staged through host
    memory)."""
    n = mesh.axis_size("model")
    group = mesh.group("model")
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    work = x.movedim(dim, 0)
    if work.element_size() == 2:
        work = work.float()
    work = work.contiguous()
    staged = _staged("reduce_scatter_tensor", x, group)
    if staged:
        work = work.cpu()
    out = work.new_empty((work.shape[0] // n, *work.shape[1:]))
    cost.collective("reduce-scatter", out.numel() * out.element_size())
    with cost.inside_collective():
        _REDUCE_SCATTER(out, work, op=dist.ReduceOp.SUM, group=group)
    if staged:
        out = out.to(x.device)
    return out.movedim(0, dim).to(x.dtype).contiguous()


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _seq_all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _seq_reduce_scatter(ct, ctx.mesh, ctx.dim), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _seq_reduce_scatter(x, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _seq_all_gather(ct, ctx.mesh, ctx.dim), None, None


def seq_gather(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole sequence of which ``x`` is this rank's block along
    ``dim`` over "model": an all-gather, whose backward reduce-scatters
    the ranks' shares of the whole value's cotangent (JAX's transpose
    of ``all_gather``)."""
    return _SeqGather.apply(x, mesh, dim)


def seq_scatter(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block along ``dim`` of the "model" ranks' sum of
    their partials ``x``: a reduce-scatter, whose backward all-gathers
    the blocks' cotangents (JAX's transpose of ``psum_scatter``)."""
    return _SeqScatter.apply(x, mesh, dim)


def seq_block(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block along ``dim`` over "model" of ``x``, a value
    every rank holds whole: a copy of its rows (so it pins nothing of
    ``x``), whose backward pads the block's cotangent with zeros, a
    share of the whole value's."""
    n = mesh.axis_size("model")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index("model") * size, size).clone(
        memory_format=torch.contiguous_format)


def to_stream(x: torch.Tensor, mesh, *, partial: bool,
              seq: bool) -> torch.Tensor:
    """A sublayer's output ``x`` in the residual stream's layout: with
    ``seq`` (the stream is sequence blocks) the ranks' partials
    reduce-scattered, or a whole value's rows; else the partials summed
    (``psum``), or ``x`` itself."""
    if seq:
        return seq_scatter(x, mesh) if partial else seq_block(x, mesh)
    return psum(x, mesh, "model") if partial else x


def pmean(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Mean over the ranks of ``axis``."""
    n = math.prod(mesh.axis_size(a) for a in _axes(axis))
    return psum(x, mesh, axis) / n


def pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis``; not differentiable."""
    return _Pmax.apply(x, mesh, _axes(axis))


def _a2a(x: torch.Tensor, mesh, axis: str, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    group = mesh.group(axis)
    staged = _staged("all_to_all", x, group)
    src = x.cpu() if staged else x
    blocks = torch.stack(src.chunk(n, dim=split_axis))
    send = _bytes(blocks).reshape(n, -1)
    recv = torch.empty_like(send)
    cost.collective("all-to-all", recv.numel())
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.view(x.dtype).reshape(blocks.shape)
    out = torch.cat(list(recv.unbind(0)), dim=concat_axis)
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _a2a(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_AllToAll.apply(ct, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis: str, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` split into the
    axis's rank count along ``split_axis``, block j sent to rank j, the
    blocks received concatenated along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


class _Enter(torch.autograd.Function):
    """A global tensor into a ``shard_map`` body: this rank's block."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return local_slice(x, spec, mesh).clone()

    @staticmethod
    def backward(ctx, ct):
        ct = gather_spec(ct, ctx.spec, ctx.mesh)
        rest = _unmentioned(ctx.spec, ctx.mesh)
        if rest:
            ct = _reduce(ct, ctx.mesh, rest, dist.ReduceOp.SUM)
        return ct, None, None


class _Exit(torch.autograd.Function):
    """A ``shard_map`` body's output to the global tensor."""

    @staticmethod
    def forward(ctx, y, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_spec(y, spec, mesh).clone()

    @staticmethod
    def backward(ctx, ct):
        n = math.prod(ctx.mesh.axis_size(a)
                      for a in _unmentioned(ctx.spec, ctx.mesh))
        ct = local_slice(ct, ctx.spec, ctx.mesh)
        return (ct / n if n > 1 else ct.clone()), None, None


def _full_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def shard_map(fn: Callable, mesh, in_specs: Sequence[Optional[tuple]],
              out_specs):
    """``fn`` run on this rank's blocks of its global arguments (one
    spec each; None: the argument is this rank's block already); its
    output, a tensor (``out_specs`` its spec) or a tuple of tensors
    (``out_specs`` a tuple of specs), all-gathered back to global
    tensors.  A mesh of one rank calls ``fn`` on the arguments
    themselves."""

    def run(*args):
        if mesh.size == 1:
            return fn(*args)
        local = [x if spec is None else
                 _Enter.apply(x, _full_spec(spec, x.ndim), mesh)
                 for x, spec in zip(args, in_specs)]
        outs = fn(*local)
        if isinstance(outs, torch.Tensor):
            return _Exit.apply(outs, _full_spec(out_specs, outs.ndim), mesh)
        return tuple(_Exit.apply(y, _full_spec(s, y.ndim), mesh)
                     for y, s in zip(outs, out_specs))

    return run
