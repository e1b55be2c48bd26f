"""The port's expert-parallel MoE paths against its global path and the
JAX package's, on 2 gloo ranks beside JAX on 2 forced host devices, on
tests/test_distributed_opts.py's config (d_model 64, 8 experts of 96,
top-2, capacity factor 8: nothing dropped), x (4, 32, 64) fp32:

* ``moe_shard_map_ep`` and ``moe_local_dispatch`` on (1, 2) and (2, 1)
  (data, model) meshes: the output within 1e-6 of the port's global
  path's and within 1e-6 of its largest magnitude of JAX's same path
  (fp32 sums in another order), and the gradient of sum(y**2) by every
  parameter leaf within 1e-5 of that leaf's largest of both; the local
  path's aux losses (per-rank means, averaged over the mesh) against
  JAX's within 1e-6 relative;
* the fallback: 3 tokens do not divide over 2 ranks, so the local path
  takes the global ``moe_forward``.  JAX's fallback passes its config on
  with the flag still set and recurses until Python's limit
  (RecursionError, checked here); the port's output equals JAX's global
  path, the result that fallback means.
"""


import jax
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro.models.common import ModelConfig as JaxConfig

from repro_torch.launch import mesh_ranks
from repro_torch.launch.mesh import spawn
from repro_torch.models.common import ModelConfig
from test_torch_mesh import SPAWN_TIMEOUT, finish_jax, start_jax

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL, AUX_TOL = 1e-6, 1e-5, 1e-6
CFG = dict(name="m", n_layers=1, d_model=64, n_heads=4, d_ff=0,
           vocab_size=10, moe=True, n_experts=8, top_k=2, d_expert=96,
           capacity_factor=8.0)
SHAPES = [(1, 2), (2, 1)]
MODES = ("moe_shard_map_ep", "moe_local_dispatch")
LEAVES = ("router", "w_down", "w_gate", "w_up")

JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models import ModelConfig
from repro.models import moe as moe_mod
from repro.launch.mesh import make_host_mesh
from repro.sharding import set_rules_for_mesh

assert len(jax.devices()) == 2
cfg_kw, params, x, x_small, shapes, out_path = json.load(open(sys.argv[1]))
cfg = ModelConfig(**cfg_kw)
p = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
x = jnp.asarray(x, jnp.float32)

def run(c, x):
    y, aux = jax.jit(lambda p, x: moe_mod.moe_forward(p, c, x))(p, x)
    g = jax.jit(jax.grad(
        lambda p, x: (moe_mod.moe_forward(p, c, x)[0] ** 2).sum()))(p, x)
    return {"y": np.asarray(y).tolist(),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": {k: np.asarray(v).tolist() for k, v in g.items()}}

out = {"global": run(cfg, x)}
for shape in shapes:
    with set_rules_for_mesh(make_host_mesh(*shape)):
        for flag in ("moe_shard_map_ep", "moe_local_dispatch"):
            out[f"{shape[0]}x{shape[1]}/{flag}"] = run(
                dataclasses.replace(cfg, **{flag: True}), x)
xs = jnp.asarray(x_small, jnp.float32)
out["small_global"] = np.asarray(moe_mod.moe_forward(p, cfg, xs)[0]).tolist()
with set_rules_for_mesh(make_host_mesh(1, 2)):
    try:
        moe_mod.moe_forward(p, dataclasses.replace(
            cfg, moe_local_dispatch=True), xs)
        out["fallback"] = "returned"
    except RecursionError:
        out["fallback"] = "RecursionError"
json.dump(out, open(out_path, "w"))
"""


def _inputs():
    cfg = JaxConfig(**CFG)
    p = jax.tree.map(lambda q: np.asarray(q.value),
                     jax_moe.init_moe(jax.random.PRNGKey(0), cfg),
                     is_leaf=lambda q: hasattr(q, "axes"))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 32, 64))
                   * 0.5, np.float32)
    x_small = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                           (1, 3, 64)) * 0.5, np.float32)
    return p, x, x_small


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    p, x, x_small = _inputs()
    proc, out = start_jax(tmp, JAX_SCRIPT, [
        CFG, {k: v.tolist() for k, v in p.items()}, x.tolist(),
        x_small.tolist(), SHAPES])
    try:
        cfg = ModelConfig(**CFG)
        calls = [(mesh_ranks.moe_paths,
                  (SHAPES, cfg, p, torch.tensor(x))),
                 (mesh_ranks.moe_paths,
                  ([(1, 2)], cfg, p, torch.tensor(x_small)))]
        port = spawn(2, mesh_ranks.in_turn, backend="gloo",
                     devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                     args=(calls,), timeout=SPAWN_TIMEOUT)
    finally:
        ref = finish_jax(proc, out)
    return ref, port


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol, (name, err)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_mesh_path_matches_global_and_jax(runs, shape, mode):
    ref, port = runs
    jax_run = ref[f"{shape[0]}x{shape[1]}/{mode}"]
    for rank in range(2):
        res = port[rank][0]
        got, glob = res[(shape, mode)], res["global"]
        _close(got["y"], glob["y"].numpy(), FWD_TOL, "y vs global")
        _close(got["y"], jax_run["y"],
               FWD_TOL * float(glob["y"].abs().max()), "y vs JAX")
        for leaf in LEAVES:
            g, g0 = got["grads"][leaf], glob["grads"][leaf]
            scale = float(g0.abs().max())
            _close(g, g0.numpy(), GRAD_TOL * scale, f"{leaf} vs global")
            _close(g, jax_run["grads"][leaf], GRAD_TOL * scale,
                   f"{leaf} vs JAX")
        for k, v in got["aux"].items():
            want = jax_run["aux"][k]
            assert abs(float(v) - want) <= AUX_TOL * abs(want), k


def test_global_path_matches_jax(runs):
    ref, port = runs
    glob = port[0][0]["global"]
    _close(glob["y"], ref["global"]["y"],
           FWD_TOL * float(glob["y"].abs().max()), "y")
    for leaf in LEAVES:
        scale = float(glob["grads"][leaf].abs().max())
        _close(glob["grads"][leaf], ref["global"]["grads"][leaf],
               GRAD_TOL * scale, leaf)


def test_local_fallback_takes_the_global_path(runs):
    ref, port = runs
    assert ref["fallback"] == "RecursionError"
    for rank in range(2):
        res = port[rank][1]
        got = res[((1, 2), "moe_local_dispatch")]["y"]
        assert torch.equal(got, res["global"]["y"])
        _close(got, ref["small_global"],
               FWD_TOL * float(got.abs().max()), "fallback vs JAX")
