"""FSDP (ZeRO-3) of the training state on a (data, model) mesh, as the
JAX package's rules lay it out under GSPMD: ``"embed"`` and
``"expert_embed"`` over ("pod", "data") (``rules.DEFAULT_RULES``), so
each rank holds 1/N of every parameter with such a dim, and of the
gradients, AdamW moments and error-feedback buffers that follow it;
``"heads"``, ``"kv_heads"``, ``"inner"``, ``"ssm_heads"``, ``"mlp"``,
``"vocab"`` and ``"experts"`` over "model" (tensor parallelism), so
each rank holds its model-axis blocks alone.

:class:`FSDP` holds each parameter leaf's spec over the mesh:
:func:`rules.param_shardings` of the leaf's logical axes on the global
shape (the divisibility fallback leaves a dim that does not divide
whole, leaf by leaf).  A leaf without a data axis in its spec (a
norm's scale) is whole on every rank of the data axes.

The model gathers a layer's blocks over the data axes when the layer
runs (:meth:`FSDP.gather`): its backward reduce-scatters the gradient
back to the block and averages it over the data ranks, in fp32, so the
whole gradient tree never exists on one rank.  A model-axis block stays
a block: the layer computes on it, and its gradient, exact on its rank,
is never summed over "model".  A leaf whole on "model" enters the
model's computation through ``collectives.enter``, which sums its
ranks' shares of the gradient (the convention of
``sharding/collectives.py``).  A replicated leaf's gather is the
identity, and its backward the same mean (an all-reduce).
:meth:`FSDP.init` draws the random parameters as blocks, each slice cut
as soon as it is drawn, so no rank ever holds the whole tree.

The same class holds the serving state's blocks (``FSDP(...,
serve=True)``): the same specs, the data-axis part gathered at use.
Which configs serve so, and the decode caches' blocks, are the serving
layer's (``serve/layout.py``).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch import tree
from repro_torch.models import weights as mw
from repro_torch.sharding.collectives import (enter, gather_spec, psum,
                                              reduce_scatter)
from repro_torch.sharding.rules import (NamedSharding, data_axes, is_axes,
                                        local_slice, param_shardings,
                                        shard_shape, spec_axes)


def _data_spec(spec: tuple, axes: tuple) -> tuple:
    """``spec`` with every mesh axis but ``axes`` dropped."""
    out = []
    for entry in spec:
        kept = tuple(a for a in spec_axes(entry) if a in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


class _Gather(torch.autograd.Function):
    """A block to its global tensor under ``spec``; the backward is the
    data ranks' mean of their cotangents, reduce-scattered to the block
    in fp32 (JAX's transpose of ``all_gather``, ``psum_scatter``, over
    the spec's axes, and a sum over the data axes the spec leaves out),
    rounded to the block's dtype at the end."""

    @staticmethod
    def forward(ctx, x, spec, mesh, data):
        ctx.args = (spec, mesh, data, x.dtype)
        out = gather_spec(x, spec, mesh)
        return out if out is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        spec, mesh, data, dtype = ctx.args
        named = {a for e in spec for a in spec_axes(e)}
        ct = reduce_scatter(ct.float(), spec, mesh)
        rest = tuple(a for a in data if a not in named)
        if rest:
            ct = psum(ct, mesh, rest)
        n = math.prod(mesh.axis_size(a) for a in data)
        return (ct / n).to(dtype), None, None, None


def held_bytes(t) -> int:
    """The bytes of every tensor leaf of ``t`` (a tree)."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t)
               if isinstance(x, torch.Tensor))


class FSDP:
    """The blocks of a parameter tree on ``mesh``.  ``axes``: the tree's
    logical axes (``models.weights.param_axes``); ``like``: a tree of
    the same structure whose leaves have the global shapes (meta tensors
    will do).  ``param_specs`` is the tree of each leaf's spec
    (``mesh`` needs more than one rank).  ``model_ranks`` is the rank
    count of the "model" axis a training layout splits (1 for a
    serving layout): the loss leaves the model through
    ``collectives.leave`` over it."""

    def __init__(self, mesh, axes, like, *, serve: bool = False):
        self.mesh, self.serve = mesh, serve
        self.axes = data_axes(mesh)
        if mesh.size == 1:
            raise ValueError(f"{mesh}: a layout of blocks on one rank")
        self.param_specs = tree.map(
            lambda s: s.spec, param_shardings(axes, mesh, like=like))
        #: the specs the layers read: ``param_specs`` (a serving layout
        #: adds its caches', ``serve/layout.py``)
        self.specs = self.param_specs
        self.model_ranks = 1 if serve or "model" not in \
            mesh.axis_names else mesh.axis_size("model")
        self.block_shapes = tree.map(
            lambda s, x: shard_shape(x.shape, s, mesh), self.param_specs,
            like, is_leaf=is_axes)

    def check_blocks(self, t) -> None:
        """Raise unless every leaf of ``t`` has its block's shape."""
        for x, want in zip(tree.leaves(t), tree.leaves(
                self.block_shapes, is_leaf=is_axes)):
            if tuple(x.shape) != want:
                what = ("under a sharded serve the serving weights are "
                        "each rank's blocks (serve.layout.serving_layout("
                        "cfg).init or .place, or params_from_numpy(fsdp=))"
                        if self.serve else "under a mesh the training "
                        "state is each rank's blocks (FSDP.place)")
                raise ValueError(
                    f"a leaf of shape {tuple(x.shape)} where its block is "
                    f"{want}: {what}")

    def _map(self, fn, t, specs=None):
        """``fn(leaf, spec)`` over ``t``, whose structure is ``specs``'
        (default: the whole tree's)."""
        specs = self.param_specs if specs is None else specs
        return tree.map(lambda s, x: fn(x, s), specs, t, is_leaf=is_axes)

    def shardings(self):
        """The tree of each leaf's :class:`NamedSharding`."""
        return tree.map(lambda s: NamedSharding(self.mesh, s),
                        self.param_specs, is_leaf=is_axes)

    def init(self, cfg, generator, device):
        """This rank's blocks of ``init_params(cfg, generator, device)``:
        the same draws from ``generator``, each slice of a leaf cut to
        its block as soon as it is drawn, so no rank holds more of the
        whole tree than one slice of one leaf."""
        order, shapes = mw.draw_order(cfg)
        specs = [None] * len(shapes)
        for i, s in zip(tree.leaves(order),
                        tree.leaves(self.param_specs, is_leaf=is_axes)):
            specs[i] = (None,) * (len(shapes[i]) - len(s)) + s
        return mw.init_params(cfg, generator, device, cuts=lambda i: (
            functools.partial(local_slice, spec=specs[i], mesh=self.mesh)))

    def place(self, t):
        """This rank's blocks of the global tensors of ``t`` (copies, so
        the caller may free the global ones)."""
        return self._map(
            lambda x, s: local_slice(x, s, self.mesh).clone(
                memory_format=torch.contiguous_format),
            t)

    def gather(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The block ``x`` of a leaf whose spec is ``spec``, gathered
        over the data axes (every rank calls it); its gradient lands in
        the block, the data ranks' mean.  A leaf whole on the "model"
        axis of a tensor-parallel layout enters through
        ``collectives.enter``."""
        x = _Gather.apply(x, _data_spec(spec, self.axes), self.mesh,
                          self.axes)
        if self.model_ranks > 1 and "model" not in {
                a for e in spec for a in spec_axes(e)}:
            x = enter(x, self.mesh, "model")
        return x

    def gather_tree(self, t, specs):
        """:meth:`gather` of every leaf of ``t`` (specs: its specs)."""
        return self._map(self.gather, t, specs)

    @torch.no_grad()
    def full(self, t, *, device=None, keep: bool = True):
        """The global tensors of the blocks ``t``, leaf by leaf on
        ``device`` (default: each leaf's), for a checkpoint or a
        result; every rank calls it.  A rank that does not ``keep``
        them drops each as soon as it is gathered (so it holds at most
        one whole leaf) and gets None."""
        def one(x, s):
            g = gather_spec(x, s, self.mesh)
            if not keep:
                return None
            return g.to(device) if device is not None else g
        out = self._map(one, t)
        return out if keep else None
