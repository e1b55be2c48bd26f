"""Elastic re-meshing, sharded checkpoint restore and data-parallel
training of the port, on 2 gloo ranks:

* ``runtime.remesh_state`` from the ranks' blocks on a (2, 1) mesh to
  each rank alone gives the global tensors back bit for bit, and
  ``ElasticRunner.restore_on_current_mesh`` restores a checkpoint as
  each rank's block on the (2, 1) mesh, then whole on (1, 1);
  ``CheckpointManager.restore(shardings=)`` and ``remesh_state`` on a
  mesh of one rank, as tests/test_checkpoint_runtime.py runs JAX's;
* ``launch.train.train_loop`` under a 2-rank data mesh (each rank half
  of every batch's rows, the gradients averaged) from JAX's weights:
  its losses within 1e-5 relative of the 1-rank run's and its final
  parameters within 1e-5 absolute (AdamW's normalised step moves an
  element whose gradient is near zero by up to lr whatever the
  gradient's size, so the averaged gradient's rounding shows there at
  the scale of lr, 1e-3), and its losses within 1e-5 of JAX's
  ``train_loop`` on a 1-device mesh;
* ``python -m repro_torch.launch.train --mesh --ranks 2`` on the CPU
  against the same launcher without ``--mesh``.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh_ranks
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.models.weights import params_from_numpy
from repro_torch.runtime import remesh_state
from repro_torch.sharding import param_shardings
from test_torch_mesh import SPAWN_TIMEOUT

torch.set_num_threads(2)

TRAIN_TOL = 1e-5
ARCH = "starcoder2-7b"
LOOP = dict(steps=3, batch=4, seq=32, lr=1e-3)
STATE = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
         "emb": torch.arange(128, dtype=torch.float32).reshape(16, 8) / 7,
         "layers": [{"norm": torch.ones(8), "wo": torch.randn(
             2, 4, 2, 8, generator=torch.Generator().manual_seed(0))}]}
AXES = {"w": ("embed", "mlp"), "emb": ("vocab", "embed"),
        "layers": [{"norm": ("embed_act",),
                    "wo": (None, "heads", "head_dim", "embed")}]}


def _jax_params():
    jcfg = jax_configs.get_config(ARCH, smoke=True)
    jstate, _ = jax_step.init_train_state(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, jstate.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = configs.get_config(ARCH, smoke=True)
    calls = [(mesh_ranks.remesh, (STATE, AXES, (2, 1), str(tmp / "ckpt"))),
             (mesh_ranks.train_data_parallel, (cfg, _jax_params(), LOOP))]
    return spawn(2, mesh_ranks.in_turn, backend="gloo",
                 devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                 args=(calls,), timeout=SPAWN_TIMEOUT)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                  tree.leaves(b)))


def test_remesh_state_two_ranks_to_one(ranks):
    for rank in range(2):
        res = ranks[rank][0]
        # "embed" lies over data on (2, 1): the blocks are halves
        assert res["blocks"]["w"] == (4, 4)
        assert res["blocks"]["emb"] == (16, 4)
        assert res["blocks"]["layers"][0]["wo"] == (2, 4, 2, 4)
        assert res["blocks"]["layers"][0]["norm"] == (8,)
        assert _equal(res["moved"], STATE)


def test_elastic_runner_restores_on_each_mesh(ranks):
    for rank in range(2):
        big, alone = (ranks[rank][0]["restored"][k]
                      for k in ("big", "alone"))
        assert big[1] == alone[1] == {"next_step": 1}
        assert big[2] == (2, 1) and alone[2] == (1, 1)
        assert _equal(alone[0], STATE)
        assert torch.equal(big[0]["w"], STATE["w"][4 * rank:4 * rank + 4])
        assert torch.equal(big[0]["emb"],
                           STATE["emb"][:, 4 * rank:4 * rank + 4])


def test_restore_with_shardings_on_one_rank(tmp_path):
    mesh = make_host_mesh(1, 1)
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    axes = {"w": ("embed", "mlp")}
    mgr.save(0, state, blocking=True)
    sh = param_shardings(axes, mesh, like=state)
    restored, _ = mgr.restore(state, shardings=sh)
    assert torch.equal(restored["w"], state["w"])
    moved = remesh_state(state, axes, mesh)
    assert torch.equal(moved["w"], state["w"])


def test_data_parallel_train_loop_matches_one_rank_and_jax(ranks):
    cfg = configs.get_config(ARCH, smoke=True)
    params = params_from_numpy(_jax_params(), cfg, device="cpu")
    state, losses = port_train.train_loop(cfg, params=params, device="cpu",
                                          **LOOP)
    jcfg = jax_configs.get_config(ARCH, smoke=True)
    _, want = jax_train.train_loop(jcfg, mesh=jax_host_mesh(1, 1), **LOOP)
    np.testing.assert_allclose(losses, want, rtol=TRAIN_TOL, atol=0)
    for rank in range(2):
        got = ranks[rank][1]
        np.testing.assert_allclose(got["losses"], losses, rtol=TRAIN_TOL,
                                   atol=0)
        for a, b in zip(tree.leaves(got["params"]),
                        tree.leaves(state.params)):
            assert float((a - b).abs().max()) <= TRAIN_TOL


def test_train_launcher_mesh_matches_single(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "16", "--device", "cpu"]
    single = port_train.main(argv)
    meshed = port_train.main(argv + ["--mesh", "--ranks", "2",
                                     "--init-file", str(tmp_path / "init")])
    assert "done: 2 steps" in capsys.readouterr().out
    np.testing.assert_allclose(meshed, single, rtol=TRAIN_TOL, atol=0)
