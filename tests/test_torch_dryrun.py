"""The port's dry-run (``repro_torch.launch.dryrun``) and assignment
cells against the JAX package's, with no devices:

* every parameter leaf's spec and shard shape on the production meshes
  (16, 16) and (2, 16, 16), for every arch at full width, equal the
  shape-aware specs JAX's rules give its ``init_params_and_axes`` leaves
  (abstract, through ``jax.eval_shape``) on a duck-typed mesh;
* the decode caches' specs by role divide, with the time dim over
  "model" where it divides;
* ``configs.SHAPES``, ``applicable``, ``cells`` and ``input_specs`` equal
  JAX's (shapes and dtypes of its ShapeDtypeStructs);
* ``run_cell``'s per-device bytes are its leaves' shard bytes, held to
  one H100's 80 GB, and ``main`` writes its JSON.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.sharding import rules as jax_rules

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.serve.engine import init_decode_state
from repro_torch.sharding import rules

MESHES = {"16x16": False, "2x16x16": True}


class DuckMesh:
    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.empty(mesh.shape, dtype=object)


def _jax_leaves(arch):
    """(shape, axes) of every leaf of JAX's abstract parameters, in the
    flatten order of the port's tree."""
    got = {}

    def init(key):
        values, got["axes"] = jax_tf.init_params_and_axes(
            key, jax_configs.get_config(arch))
        return values

    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = jax.tree.leaves(got["axes"], is_leaf=lambda x: isinstance(x,
                                                                   tuple))
    return [(tuple(s.shape), a) for s, a in zip(jax.tree.leaves(sds), axes)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_specs_equal_jax(arch, mesh_name):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    duck = DuckMesh(mesh)
    got = dryrun.param_specs(configs.get_config(arch), mesh)
    want = _jax_leaves(arch)
    assert len(got) == len(want)
    for (path, shape, spec), (jshape, jaxes) in zip(got, want):
        assert shape == jshape, path
        jspec = tuple(jax_rules.logical_to_mesh_axes(
            jaxes, None, duck, shape=jshape))
        assert spec == jspec, path
        local = rules.shard_shape(shape, spec, mesh)
        per = [math.prod(dict(zip(mesh.axis_names, mesh.shape))[a]
                         for a in rules.spec_axes(e)) for e in jspec]
        assert local == tuple(d // n for d, n in zip(jshape, per)), path


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_decode_cache_specs_divide(arch):
    cfg = configs.get_config(arch)
    mesh = make_production_mesh()
    state = init_decode_state(cfg, 128, 32768, cfg.torch_dtype(),
                              device="meta")
    leaves = dict(dryrun._paths(state))
    specs = dryrun.decode_state_specs(state, mesh)
    assert len(specs) == len(leaves)
    time_sharded = 0
    for path, spec in specs:
        rules.shard_shape(leaves[path].shape, spec, mesh)
        if path.endswith(("/k", "/v", "/latent")):
            assert spec[-2] == "model", path
            time_sharded += 1
        if path.endswith("cache_len"):
            assert spec == (None,)
    assert time_sharded > 0


def test_shapes_and_cells_equal_jax():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in configs.SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in jax_configs.SHAPES.items()}
    assert configs.SUBQUADRATIC == jax_configs.SUBQUADRATIC
    assert configs.ENCODER_ONLY == jax_configs.ENCODER_ONLY
    assert sorted(configs.cells()) == sorted(jax_configs.cells())
    for arch in configs.list_archs():
        for shape in configs.SHAPES:
            assert configs.applicable(arch, shape) == \
                jax_configs.applicable(arch, shape)


def _described(tree_):
    if isinstance(tree_, dict):
        return {k: _described(v) for k, v in tree_.items()}
    if isinstance(tree_, int):
        return tree_
    return (tuple(tree_.shape), str(tree_.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_input_specs_equal_jax(arch):
    for shape in configs.SHAPES:
        got = _described(configs.input_specs(arch, shape))
        want = jax.tree.map(
            lambda s: s if isinstance(s, int) else (tuple(s.shape),
                                                    str(s.dtype)),
            jax_configs.input_specs(arch, shape))
        assert got == want, shape


def test_run_cell_counts_its_shards(tmp_path, capsys):
    r = dryrun.run_cell("starcoder2-7b", "train_4k", multi_pod=False,
                        costs=False)
    params = sum(math.prod(leaf["shard"]) for leaf in r["leaves"])
    dt = configs.get_config("starcoder2-7b").torch_dtype("param")
    size = torch.empty((), dtype=dt).element_size()
    assert r["per_device_bytes"]["params"] == params * size
    # two bf16 moments a parameter, and the int32 step
    assert r["per_device_bytes"]["optimizer"] == 2 * params * 2 + 4
    assert r["devices"] == 256 and r["device_bytes"] == 80e9
    assert r["fits_device"]
    assert dryrun.run_cell("hubert-xlarge", "decode_32k",
                           multi_pod=True)["skipped"]
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [row["mesh"] for row in rows] == ["16x16", "2x16x16"]
    assert rows[0]["per_device_bytes"]["caches"] > 0
    assert "fits=True" in capsys.readouterr().out


def test_run_cell_takes_a_serves_geometry():
    """A decode cell's figure at a serve's own batch and max_len (what a
    rank of the sharded serving state holds): the caches are that
    geometry's K/V, the time over (1, 2)'s model axis, beside the whole
    cache_len and last_token; the parameters are the cell's; a train
    cell refuses the two."""
    mesh = Mesh(("data", "model"), (1, 2))
    cfg = configs.get_config("starcoder2-7b")
    base = dryrun.run_cell("starcoder2-7b", "decode_32k", mesh=mesh,
                           costs=False)
    r = dryrun.run_cell("starcoder2-7b", "decode_32k", mesh=mesh, batch=4,
                        max_len=1024, costs=False)
    kv = 2 * cfg.n_layers * 4 * cfg.kv_heads * 1024 * cfg.head_dim * 2 // 2
    assert r["per_device_bytes"]["caches"] == kv + 2 * 4 * 4
    assert r["per_device_bytes"]["params"] \
        == base["per_device_bytes"]["params"]
    assert base["per_device_bytes"]["caches"] > r["per_device_bytes"]["caches"]
    with pytest.raises(ValueError, match="decode cell"):
        dryrun.run_cell("starcoder2-7b", "train_4k", mesh=mesh, batch=4)
