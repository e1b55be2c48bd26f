"""The sharded serving state: which configs serve on blocks under a
mesh, and the blocks of their decode caches.

On a mesh of more than one rank with a ``model`` axis and
``head_parallel_decode`` or ``distributed_decode`` set, each rank holds
its blocks of JAX's serving layout (``launch/dryrun.py``'s
``lower_cell``): the weights on ``param_shardings``
(``sharding.fsdp.FSDP(..., serve=True)``), so ``heads``, ``kv_heads``,
``mlp``, ``vocab`` and ``experts`` lie over ``model`` and
``embed``/``expert_embed`` over the data axes, each dim whole where it
does not divide (``logical_to_mesh_axes``' fallback, leaf by leaf, as
JAX's rules keep it); and the K/V caches in blocks
(:func:`cache_blocks`): the batch over the data axes, and over
``model`` the time columns under ``distributed_decode`` (JAX's
``decode_state_shardings``) or the KV heads under
``head_parallel_decode`` (``head_parallel_decode_attention``'s
in-specs).  ``models/`` reads from the layout's specs which leaves are
blocks and consumes them as blocks.  A mesh with neither flag serves
the whole state on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import transformer as tf
from repro_torch.models import weights as mw
from repro_torch.serve import distributed_decode as dd
from repro_torch.sharding.collectives import gather_spec
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import (active_mesh, block_index,
                                        logical_to_mesh_axes, shard_shape)

#: where the serving layouts that are not ported yet stand
_QUEUE = "see ROADMAP.md, Queue 1"


def sharded_serving(cfg, mesh) -> bool:
    """Whether ``cfg`` serves on blocks under ``mesh``: a mesh of more
    than one rank with a ``model`` axis and ``head_parallel_decode`` or
    ``distributed_decode`` set."""
    return (mesh is not None and mesh.size > 1
            and "model" in mesh.axis_names
            and (cfg.head_parallel_decode or cfg.distributed_decode))


def _refuse(cfg, mesh) -> None:
    """The configs the sharded serving state does not cover yet, and
    the head counts head-parallel decode cannot split (JAX raises the
    same)."""
    what = "the sharded serving state (each rank its blocks on the " \
        "model axis)"
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: {what} covers GQA attention; MLA's latent cache "
            f"(seq_kv over model) is not laid out yet ({_QUEUE})")
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    if "mamba" in kinds:
        part = ("the attention/Mamba-2 hybrid's mixed cache" if "attn" in
                kinds else "Mamba-2's conv and ssm state (inner and "
                "ssm_heads over model)")
        raise NotImplementedError(
            f"{cfg.name}: {what} covers GQA attention; {part} is not laid "
            f"out yet ({_QUEUE})")
    if cfg.head_parallel_decode and not cfg.distributed_decode:
        dd.check_head_parallel(cfg.n_heads, cfg.kv_heads,
                               mesh.axis_size("model"))


def serving_layout(cfg, mesh=None) -> Optional[fsdp.FSDP]:
    """The blocks of ``cfg``'s serving weights on ``mesh`` (default: the
    active one), JAX's ``param_shardings``, or None where it serves the
    whole state (:func:`sharded_serving`).  Raises NotImplementedError
    for a config whose serving state the port does not lay out on a
    mesh yet (MLA, Mamba-2, the hybrid), and ValueError where
    ``head_parallel_decode``'s heads do not divide the model axis."""
    mesh = mesh if mesh is not None else active_mesh()
    if not sharded_serving(cfg, mesh):
        return None
    _refuse(cfg, mesh)
    return fsdp.FSDP(mesh, mw.param_axes(cfg),
                     mw.init_params(cfg, None, "meta"), serve=True)


def batch_block(layout: fsdp.FSDP, batch: int) -> tuple:
    """(first row, row count) of this rank's rows of a batch of
    ``batch`` rows: the ``"batch"`` rule over the data axes, the whole
    batch where it does not divide (a B=1 prefill)."""
    mesh = layout.mesh
    entry = logical_to_mesh_axes(("batch",), mesh=mesh, shape=(batch,))[0]
    idx, n = block_index(entry, mesh, mesh.coords)
    return idx * (batch // n), batch // n


def gather_rows(layout: fsdp.FSDP, x: torch.Tensor, batch: int,
                dim: int = 0) -> torch.Tensor:
    """The whole batch of which ``x`` holds this rank's rows along
    ``dim`` (every rank calls it)."""
    mesh = layout.mesh
    entry = logical_to_mesh_axes(("batch",), mesh=mesh, shape=(batch,))[0]
    spec = [None] * x.ndim
    spec[dim] = entry
    return gather_spec(x, tuple(spec), mesh)


def cache_blocks(layout: fsdp.FSDP, cfg, batch: int, max_len: int, dtype,
                 device) -> dict:
    """This rank's zeroed blocks of ``tf.init_model_cache(cfg, batch,
    max_len, dtype)``: no rank allocates the whole cache.  Raises
    ValueError where ``max_len`` does not divide over the ``model`` axis
    under ``distributed_decode`` (JAX's ``shard_map`` refuses it)."""
    mesh = layout.mesh
    if cfg.distributed_decode:
        dd.check_seq_sharded(max_len, mesh.axis_size("model"))
    # each K/V leaf (*lead, B, Hkv, max_len, D): the batch over the data
    # axes, over "model" the time columns or the KV heads
    logical = ("batch", None, "seq_kv", None) if cfg.distributed_decode \
        else ("batch", "kv_heads", None, None)

    def block(x):
        lead = x.ndim - len(logical)
        spec = (None,) * lead + logical_to_mesh_axes(
            logical, mesh=mesh, shape=x.shape[lead:])
        return torch.zeros(shard_shape(x.shape, spec, mesh), dtype=dtype,
                           device=device)
    return tree.map(block, tf.init_model_cache(cfg, batch, max_len, dtype,
                                               "meta"))
