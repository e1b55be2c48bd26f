"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding.rules``, in plain Python with no devices:

* the rule tables equal JAX's;
* ``logical_to_mesh_axes`` equals JAX's for both rule sets on (1, 1),
  (2, 1), (1, 2), (2, 4), (16, 16) and (2, 16, 16) meshes (duck-typed:
  ``axis_names`` and a numpy ``devices`` array, which JAX's function
  reads without devices), with and without shapes, dividing and not,
  duplicate axes included, and with no mesh;
* ``param_axes(cfg)`` equals the axes tree of
  ``repro.models.transformer.init_params_and_axes`` for every ported
  arch at smoke width, its structure that of ``init_params``;
* ``shard_shape`` and ``local_slice``: every rank's block tiles the
  global tensor once, and a dim that does not divide raises.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.sharding import rules as jax_rules

from repro_torch import configs, tree
from repro_torch.launch.mesh import Mesh
from repro_torch.models.weights import init_params, param_axes
from repro_torch.sharding import rules

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULE_SETS = {"default": (rules.DEFAULT_RULES, jax_rules.DEFAULT_RULES),
             "seq_parallel": (rules.RULES_SEQ_PARALLEL,
                              jax_rules.RULES_SEQ_PARALLEL)}

#: logical tuples: every rule alone, the model's parameter and cache
#: tuples, duplicate mesh axes, unknown and None axes
LOGICALS = [(name,) for name in rules.DEFAULT_RULES] + [
    ("batch", "heads", "seq", "head_dim"), ("heads", "kv_heads"),
    ("tokens", "heads"), ("embed", "mlp"), ("mlp", "embed"),
    ("experts", "expert_embed", "expert_mlp"),
    ("experts", "expert_mlp", "expert_embed"), ("embed", "experts"),
    ("batch", None, "seq_kv", None), ("batch", "seq_kv", None),
    ("batch", "ssm_heads", None, None), ("batch", None, "inner"),
    ("vocab", "embed"), ("embed", "vocab"), (None, "embed", "heads",
                                             "head_dim"),
    ("latent", "heads", "head_dim"), ("batch", "seq", "seq_kv"),
    ("tokens", "tokens_out"), (None, "nonexistent-axis"), ()]
#: dims for the shape-aware fallback: dividing every mesh, and not
DIMS = (4096, 40, 3, 2, 32, 1)


class DuckMesh:
    """What JAX's ``logical_to_mesh_axes`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def test_rule_tables_equal_jax():
    assert rules.DEFAULT_RULES == jax_rules.DEFAULT_RULES
    assert rules.RULES_SEQ_PARALLEL == jax_rules.RULES_SEQ_PARALLEL


def _shapes(n: int) -> list:
    if n == 0:
        return [()]
    rng = np.random.default_rng(n)
    picks = [tuple(int(d) for d in rng.choice(DIMS, n)) for _ in range(6)]
    return [(4096,) * n, (3,) * n] + picks


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rule_set", list(RULE_SETS))
def test_logical_to_mesh_axes_equals_jax(mesh_name, rule_set):
    shape, axes = MESHES[mesh_name]
    mesh = DuckMesh(shape, axes)
    port_rules, jax_r = RULE_SETS[rule_set]
    for logical in LOGICALS:
        want = tuple(jax_rules.logical_to_mesh_axes(logical, jax_r, mesh))
        assert rules.logical_to_mesh_axes(logical, port_rules, mesh) \
            == want, logical
        for dims in _shapes(len(logical)):
            want = tuple(jax_rules.logical_to_mesh_axes(
                logical, jax_r, mesh, shape=dims))
            got = rules.logical_to_mesh_axes(logical, port_rules, mesh,
                                             shape=dims)
            assert got == want, (logical, dims)


@pytest.mark.parametrize("rule_set", list(RULE_SETS))
def test_logical_to_mesh_axes_without_a_mesh_equals_jax(rule_set):
    port_rules, jax_r = RULE_SETS[rule_set]
    for logical in LOGICALS:
        assert rules.logical_to_mesh_axes(logical, port_rules) == tuple(
            jax_rules.logical_to_mesh_axes(logical, jax_r, None)), logical


def test_active_rules_and_mesh_are_scoped():
    mesh = Mesh(("data", "model"), (2, 4))
    assert rules.active_mesh() is None
    with rules.set_rules_for_mesh(mesh, rules.RULES_SEQ_PARALLEL):
        assert rules.active_mesh() is mesh
        assert rules.logical_to_mesh_axes(("seq", "heads")) == \
            ("model", None)
    assert rules.active_mesh() is None
    assert rules.logical_to_mesh_axes(("seq", "heads")) == (None, "model")


def _jax_axes(arch):
    cfg = jax_configs.get_config(arch, smoke=True)
    got = {}

    def init(key):
        values, got["axes"] = jax_tf.init_params_and_axes(key, cfg)
        return values

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return got["axes"]


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_axes_equal_jax(arch):
    cfg = configs.get_config(arch, smoke=True)
    axes = param_axes(cfg)
    assert axes == _jax_axes(arch)
    params = init_params(cfg, None, "meta")
    flat = tree.leaves(axes, is_leaf=rules.is_axes)
    assert len(flat) == len(tree.leaves(params))
    for ax, p in zip(flat, tree.leaves(params)):
        assert len(ax) == p.ndim


@pytest.mark.parametrize("mesh_name", ["2x1", "1x2", "2x4", "2x16x16"])
def test_local_slices_tile_the_tensor(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = Mesh(axes, shape)
    x = torch.arange(64 * 32 * 3, dtype=torch.float32).reshape(64, 32, 3)
    specs = [(axes[-1], None, None), (None, axes[0], None),
             (tuple(axes[:2]), None, None), (axes[0], axes[-1], None)]
    for spec in specs:
        seen = torch.zeros_like(x)
        for r in range(mesh.size):
            block = rules.local_slice(x, spec, mesh, rank=r)
            assert tuple(block.shape) == rules.shard_shape(x.shape, spec,
                                                           mesh)
            # the block is a view: mark where it lies
            seen.view(-1)[block.reshape(-1).long()] += 1
        n_rep = mesh.size // np.prod([
            mesh.axis_size(a) for e in spec for a in rules.spec_axes(e)])
        assert torch.equal(seen, torch.full_like(x, float(n_rep))), spec


def test_shard_shape_raises_where_a_dim_does_not_divide():
    mesh = Mesh(("data", "model"), (16, 16))
    assert rules.shard_shape((4096, 40), ("data", None), mesh) == (256, 40)
    with pytest.raises(ValueError, match="does not divide"):
        rules.shard_shape((4096, 40), (None, "model"), mesh)


@pytest.mark.parametrize("mesh_name,arch", list(itertools.product(
    ["16x16", "2x16x16"], ["starcoder2-7b", "jamba-1.5-large-398b"])))
def test_param_shardings_follow_the_fallback(mesh_name, arch):
    """``param_shardings(like=)``: each leaf's spec is the shape-aware
    resolution of its axes, so every shard shape divides."""
    shape, axes_names = MESHES[mesh_name]
    mesh = Mesh(axes_names, shape)
    cfg = configs.get_config(arch, smoke=True)
    params, axes = init_params(cfg, None, "meta"), param_axes(cfg)
    shardings = rules.param_shardings(axes, mesh, like=params)
    for ax, p, s in zip(tree.leaves(axes, is_leaf=rules.is_axes),
                        tree.leaves(params), tree.leaves(shardings)):
        assert s.spec == rules.logical_to_mesh_axes(ax, mesh=mesh,
                                                    shape=p.shape)
        s.shard_shape(p.shape)
