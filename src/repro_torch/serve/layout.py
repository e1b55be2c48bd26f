"""The sharded serving state: the blocks of the serving weights and of
the decode caches on the model axis.

On a mesh of more than one rank with a ``model`` axis and
``head_parallel_decode`` or ``distributed_decode`` set, each rank holds
its blocks of JAX's serving layout (``launch/dryrun.py``'s
``lower_cell``): the weights on ``param_shardings``
(``sharding.fsdp.FSDP(..., serve=True)``), so ``heads``, ``kv_heads``,
``mlp``, ``vocab``, ``experts``, ``inner`` and ``ssm_heads`` lie over
``model`` and ``embed``/``expert_embed`` over the data axes, each dim
whole where it does not divide (``logical_to_mesh_axes``' fallback,
leaf by leaf, as JAX's rules keep it); and the decode caches in blocks
by role (:func:`cache_blocks`), the batch over the data axes and over
``model``: a GQA layer's K/V by their time columns under
``distributed_decode`` (JAX's ``decode_state_shardings``) or by their
KV heads under ``head_parallel_decode``
(``head_parallel_decode_attention``'s in-specs); MLA's latent by its
time columns, Mamba-2's conv tail by its channels and its SSM state by
its heads under either flag (``decode_state_shardings``: neither
JAX's ``mla_forward`` nor its ``mamba_forward`` reads the flags).
``models/`` reads from the layout's specs which leaves are blocks and
consumes them as blocks.  A mesh with neither flag serves the whole
state on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models import weights as mw
from repro_torch.serve import distributed_decode as dd
from repro_torch.sharding.collectives import gather_spec
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import (active_mesh, block_index,
                                        logical_to_mesh_axes, shard_shape)


def cache_logical(key: str, nd: int) -> tuple:
    """A decode-state leaf's logical axes by its role and its path
    ``key`` ("/"-joined keys; the JAX dry-run's
    ``decode_state_shardings``): batch over (pod, data), the cache's
    time dim over model, SSM heads and conv channels over model."""
    if key.endswith("cache_len"):
        return (None,) * nd
    if key.endswith("last_token"):
        logical = ("batch",)
    elif key.endswith("/k") or key.endswith("/v"):
        logical = ("batch", None, "seq_kv", None)
    elif key.endswith("latent"):
        logical = ("batch", "seq_kv", None)
    elif key.endswith("conv"):
        logical = ("batch", None, "inner")
    elif key.endswith("ssm"):
        logical = ("batch", "ssm_heads", None, None)
    else:
        logical = ("batch",) + (None,) * (nd - 1)
    return (None,) * (nd - len(logical)) + logical


def sharded_serving(cfg, mesh) -> bool:
    """Whether ``cfg`` serves on blocks under ``mesh``: a mesh of more
    than one rank with a ``model`` axis and ``head_parallel_decode`` or
    ``distributed_decode`` set."""
    return (mesh is not None and mesh.size > 1
            and "model" in mesh.axis_names
            and (cfg.head_parallel_decode or cfg.distributed_decode))


def _gqa_layers(cfg) -> bool:
    """Whether ``cfg`` has GQA attention layers (K/V caches)."""
    return cfg.attention != "mla" and any(
        cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


class ServingLayout(fsdp.FSDP):
    """``FSDP(..., serve=True)`` of ``cfg``'s serving weights on
    ``mesh``, and the ``max_len`` of the decode caches laid out on it
    (None: weights alone; :func:`cache_blocks` needs it).  With
    ``max_len``, ``specs`` also gives each MLA layer's ``attn`` its
    latent cache's spec under ``"latent"`` (:func:`cache_spec`: its time
    columns over "model" where ``max_len`` divides, whole where it does
    not), so the layers read every block from the one tree."""

    def __init__(self, cfg, mesh, max_len: Optional[int] = None):
        super().__init__(mesh, mw.param_axes(cfg),
                         mw.init_params(cfg, None, "meta"), serve=True)
        self.cfg, self.max_len = cfg, max_len
        if max_len is not None and cfg.attention == "mla":
            latent = cache_spec(self, cfg, "/latent", (
                1, max_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim))
            self.specs = _with_latent(self.param_specs, latent)


def _with_latent(specs: dict, latent: tuple) -> dict:
    """``specs`` with ``latent`` under each layer's ``attn`` (a stacked
    layer's with its period axis)."""
    def add(layer, lead):
        if "attn" not in layer:
            return layer
        return dict(layer, attn=dict(layer["attn"],
                                     latent=(None,) * lead + latent))
    return dict(specs,
                prefix_layers=[add(s, 0) for s in specs["prefix_layers"]],
                layers=[add(s, 1) for s in specs["layers"]])


def serving_layout(cfg, mesh=None, *,
                   max_len: Optional[int] = None) -> Optional[ServingLayout]:
    """The blocks of ``cfg``'s serving weights on ``mesh`` (default: the
    active one), JAX's ``param_shardings``, or None where it serves the
    whole state (:func:`sharded_serving`); ``max_len``: the decode
    caches' (:class:`ServingLayout`).  Raises ValueError where
    ``head_parallel_decode``'s heads do not divide the model axis at a
    GQA attention layer (JAX's ``check_head_parallel``); MLA's one
    latent head has no head-parallel form, and Mamba-2 layers have no
    attention heads."""
    mesh = mesh if mesh is not None else active_mesh()
    if not sharded_serving(cfg, mesh):
        return None
    if cfg.head_parallel_decode and not cfg.distributed_decode \
            and _gqa_layers(cfg):
        dd.check_head_parallel(cfg.n_heads, cfg.kv_heads,
                               mesh.axis_size("model"))
    return ServingLayout(cfg, mesh, max_len)


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


def _with_paths(fn, node, prefix=""):
    """``node`` (a dict/list tree) with each tensor leaf ``x`` replaced
    by ``fn(path, x)``, ``path`` its "/"-joined keys."""
    if isinstance(node, dict):
        return {k: _with_paths(fn, v, f"{prefix}/{k}")
                for k, v in node.items()}
    if isinstance(node, list):
        return [_with_paths(fn, v, f"{prefix}/{i}")
                for i, v in enumerate(node)]
    return fn(prefix, node)


def cache_spec(layout: fsdp.FSDP, cfg, path: str, shape) -> tuple:
    """The spec of the decode-cache leaf at ``path`` of global ``shape``
    on ``layout``'s mesh: its role's logical axes (:func:`cache_logical`)
    resolved shape-aware, but a GQA layer's K/V under
    ``head_parallel_decode`` alone, which lie by KV heads."""
    logical = cache_logical(path, len(shape))
    if (path.endswith("/k") or path.endswith("/v")) \
            and not cfg.distributed_decode:
        logical = logical[:-4] + ("batch", "kv_heads", None, None)
    return logical_to_mesh_axes(logical, mesh=layout.mesh, shape=shape)


def cache_blocks(layout: ServingLayout, cfg, batch: int, max_len: int,
                 dtype, device) -> dict:
    """This rank's zeroed blocks of ``tf.init_model_cache(cfg, batch,
    max_len, dtype)``, each leaf by its role (:func:`cache_spec`): no
    rank allocates a whole leaf that JAX's layout splits.  Raises
    ValueError where ``max_len`` does not divide over the ``model`` axis
    under ``distributed_decode`` at a GQA layer (JAX's ``shard_map``
    refuses it); MLA's latent then stays whole, as JAX's shape-aware
    rule keeps it (no ``shard_map`` reads it).  ``layout`` must have
    been made for this ``max_len`` (``serving_layout(..., max_len=)``;
    ValueError otherwise)."""
    mesh = layout.mesh
    if layout.max_len != max_len:
        raise ValueError(f"a cache of max_len {max_len} on a serving "
                         f"layout of max_len {layout.max_len} (pass "
                         "max_len to serving_layout)")
    if cfg.distributed_decode and _gqa_layers(cfg):
        dd.check_seq_sharded(max_len, mesh.axis_size("model"))

    def block(path, x):
        spec = cache_spec(layout, cfg, path, x.shape)
        return torch.zeros(shard_shape(x.shape, spec, mesh), dtype=x.dtype,
                           device=device)
    return _with_paths(block, tf.init_model_cache(cfg, batch, max_len, dtype,
                                                  "meta"))
