"""FSDP (ZeRO-3) training of the port on a data mesh of 2 gloo ranks
(``launch.mesh.spawn``, one spawn for the file), against the port's
single-rank run and the JAX package on the global batch (a 1-device
mesh has GSPMD's semantics), from JAX's weights (``params_from_numpy``)
of starcoder2-7b's and phi3.5-moe's smoke configs:

* ``launch.train.train_loop``'s losses within 1e-5 relative of the
  1-rank run's and of JAX's ``train_loop``, its final parameters
  (gathered from the blocks) within 1e-5 absolute of the 1-rank run's;
* each rank's held bytes of parameters, gradients and AdamW state equal
  the sum of ``shard_shape`` over ``param_shardings`` and the dry-run's
  ``per_device_bytes`` for the (2, 1) mesh, less than the whole tree's;
  every leaf with an ``embed``/``expert_embed`` dim that divides is
  halved, the others whole;
* one ``train_step``: phi3.5-moe's ``moe_lb_loss`` (from the global
  batch's token fractions and mean probabilities), loss, total and
  every gradient leaf (the router's among them) within 1e-5 of JAX's
  ``loss_fn`` on the global batch; a masked batch whose ranks hold 5
  and 30 tokens: the loss (the global token mean) and every gradient
  leaf within 1e-5 of JAX's;
* ``global_norm`` and the int8 scales of blocks equal the whole
  tensors', a replicated leaf among them, and int8 compression on blocks
  trains within 1e-5 of the single rank; a checkpoint saved from blocks
  (gathered, rank 0 alone keeping and writing) restored with
  ``shardings=`` bit for bit, and a run crashed and resumed from its
  blocks bit for bit the uninterrupted run;
* ``launch.train.build`` on a data mesh draws each rank's blocks of the
  single rank's random weights, bit for bit, for every arch;
* the same step under remat ``full`` and ``dots`` (the gathers inside
  each layer's checkpoint, again in its recompute) within 1e-5 of JAX's;
* a mesh of one rank is bit-equal to the mesh-less step.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import transformer as jax_tf
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.launch import dryrun, mesh_ranks
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.weights import param_axes, params_from_numpy
from repro_torch.sharding import param_shardings, set_rules_for_mesh
from repro_torch.sharding.rules import shard_shape
from repro_torch.train import step as port_step
from test_torch_mesh import SPAWN_TIMEOUT

torch.set_num_threads(2)

TOL = 1e-5
ARCHS = ["starcoder2-7b", "phi3.5-moe-42b-a6.6b"]
LOOP = dict(steps=3, batch=4, seq=32, lr=1e-3)
STEP_B, STEP_S, STEP_LR = 4, 32, 1e-3
#: tokens per row of the masked batch: rank 0's rows, then rank 1's
MASK_TOKENS = (2, 3, 14, 16)
TWO = Mesh(("data", "model"), (2, 1))       # the ranks' mesh, shapes only
#: the smoke configs keep every activation; the gathers under remat
REMATS = [("starcoder2-7b", "full"), ("starcoder2-7b", "dots"),
          ("phi3.5-moe-42b-a6.6b", "full")]


def _jax(arch):
    """(JAX cfg, JAX params, numpy params) of the arch's smoke config."""
    jcfg = jax_configs.get_config(arch, smoke=True)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(cfg, masked: bool) -> dict:
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (STEP_B, STEP_S + 1)).astype(np.int32)}
    if masked:
        cols = np.arange(STEP_S)[None, :]
        out["mask"] = (cols < np.array(MASK_TOKENS)[:, None]).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    calls = []
    for arch in ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        params_np = _jax(arch)[2]
        calls.append((mesh_ranks.train_data_parallel,
                      (cfg, params_np, LOOP)))
        for masked in (False, True):
            batch = {k: torch.from_numpy(v)
                     for k, v in _batch(cfg, masked).items()}
            calls.append((mesh_ranks.train_step_on_mesh,
                          (cfg, params_np, batch, STEP_LR)))
    for arch, remat in REMATS:
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                  remat=remat)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(cfg, False).items()}
        calls.append((mesh_ranks.train_step_on_mesh,
                      (cfg, _jax(arch)[2], batch, STEP_LR)))
    cfg = configs.get_config(ARCHS[0], smoke=True)
    calls.append((mesh_ranks.fsdp_state,
                  (cfg, _jax(ARCHS[0])[2], LOOP, str(tmp / "ckpt"))))
    out = spawn(2, mesh_ranks.in_turn, backend="gloo",
                devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                args=(calls,), timeout=SPAWN_TIMEOUT)
    return [{"loop": dict(zip(ARCHS, r[0:6:3])),
             "step": {(a, m): r[1 + 3 * i + m] for i, a in enumerate(ARCHS)
                      for m in (0, 1)},
             "remat": dict(zip(REMATS, r[6:-1])),
             "state": r[-1]} for r in out]


def _grads_close(got, want):
    """Every gradient leaf within TOL of its largest magnitude."""
    jl = [np.asarray(x) for x in jax.tree.leaves(want)]
    gl = tree.leaves(got)
    assert len(jl) == len(gl)
    for w, g in zip(jl, gl):
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * max(np.abs(w).max(), 1e-30), (w.shape, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_train_loop_matches_one_rank_and_jax(ranks, arch):
    cfg = configs.get_config(arch, smoke=True)
    jcfg, _, params_np = _jax(arch)
    state, losses = port_train.train_loop(
        cfg, params=params_from_numpy(params_np, cfg, device="cpu"),
        device="cpu", **LOOP)
    _, want = jax_train.train_loop(jcfg, mesh=jax_host_mesh(1, 1), **LOOP)
    np.testing.assert_allclose(losses, want, rtol=TOL, atol=0)
    for rank in range(2):
        got = ranks[rank]["loop"][arch]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=0)
        np.testing.assert_allclose(got["losses"], want, rtol=TOL, atol=0)
        for a, b in zip(tree.leaves(got["params"]),
                        tree.leaves(state.params)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_blocks_only(ranks, arch):
    cfg = configs.get_config(arch, smoke=True)
    params = params_from_numpy(_jax(arch)[2], cfg, device="cpu")
    axes = param_axes(cfg)
    shardings = param_shardings(axes, TWO, like=params)
    blocks = [shard_shape(x.shape, s.spec, TWO) for x, s in
              zip(tree.leaves(params), tree.leaves(shardings))]
    block_bytes = sum(math.prod(b) * x.element_size()
                      for b, x in zip(blocks, tree.leaves(params)))
    # fp32 moments, two of them, and AdamW's int32 step
    moments = 2 * 4 * sum(math.prod(b) for b in blocks) + 4
    whole = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    cell = dryrun.run_cell(arch, "train_4k", cfg=cfg, mesh=TWO,
                           moment_dtype="float32",
                           costs=False)["per_device_bytes"]
    for rank in range(2):
        got = ranks[rank]["loop"][arch]
        assert got["held"] == {"params": block_bytes, "grads": block_bytes,
                               "optimizer": moments}
        assert got["held"]["params"] == cell["params"]
        assert got["held"]["optimizer"] == cell["optimizer"]
        assert got["held"]["params"] < whole
        halved = 0
        for shape, x, ax in zip(tree.leaves(got["block_shapes"],
                                            is_leaf=lambda t: isinstance(
                                                t, tuple)),
                                tree.leaves(params),
                                tree.leaves(axes, is_leaf=lambda t:
                                            isinstance(t, tuple))):
            want = list(x.shape)
            for i, name in enumerate(ax):
                if name in ("embed", "expert_embed") and want[i] % 2 == 0:
                    want[i] //= 2
                    break
            assert shape == tuple(want), (ax, x.shape, shape)
            halved += shape != tuple(x.shape)
        assert 0 < halved < len(blocks)


def _jax_step(arch, masked):
    jcfg, jparams, _ = _jax(arch)
    batch = {k: jnp.asarray(v) for k, v in
             _batch(configs.get_config(arch, smoke=True), masked).items()}
    return jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, batch), has_aux=True)(jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_jax_on_the_global_batch(ranks, arch):
    """The MoE load-balance loss from the global batch's means, and the
    router's gradient through it."""
    (jtot, jm), jgrads = _jax_step(arch, masked=False)
    for rank in range(2):
        got = ranks[rank]["step"][(arch, 0)]
        m = got["metrics"]
        for key in ("loss", "moe_lb_loss", "moe_z_loss"):
            assert m[key] == pytest.approx(float(jm[key]), rel=TOL,
                                           abs=0 if float(jm[key]) else 1e-12)
        total = m["loss"] + 0.01 * m["moe_lb_loss"] + 0.001 * m["moe_z_loss"]
        assert total == pytest.approx(float(jtot), rel=TOL)
        _grads_close(got["grads"], jgrads)
    if arch.startswith("phi"):
        assert float(jm["moe_lb_loss"]) > 0
        router = np.asarray(jgrads["layers"][0]["moe"]["router"])
        assert np.abs(router).max() > 0


@pytest.mark.parametrize("arch,remat", REMATS)
def test_one_step_under_remat_matches_jax(ranks, arch, remat):
    """A checkpointed layer gathers its blocks inside the checkpoint, so
    its recompute gathers them again."""
    (jtot, jm), jgrads = _jax_step(arch, masked=False)
    for rank in range(2):
        got = ranks[rank]["remat"][(arch, remat)]
        assert got["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                       rel=TOL)
        _grads_close(got["grads"], jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_batch_with_unequal_ranks_matches_jax(ranks, arch):
    (jtot, jm), jgrads = _jax_step(arch, masked=True)
    for rank in range(2):
        got = ranks[rank]["step"][(arch, 1)]
        assert got["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                       rel=TOL)
        _grads_close(got["grads"], jgrads)


def test_norm_and_int8_scales_of_blocks_are_the_whole_tensors(ranks):
    for rank in range(2):
        st = ranks[rank]["state"]
        blocks, whole = st["norm"]
        assert blocks == pytest.approx(whole, rel=1e-6)
        assert st["scales"][0] == st["scales"][1]
        specs = st["specs"]
        assert any(all(e is None for e in s) for s in specs)   # whole
        assert any(any(e is not None for e in s) for s in specs)


def test_checkpoint_of_blocks_round_trips_bitwise(ranks):
    cfg = configs.get_config(ARCHS[0], smoke=True)
    params = params_from_numpy(_jax(ARCHS[0])[2], cfg, device="cpu")
    _, want = port_train.train_loop(cfg, params=params, device="cpu",
                                    grad_compression=True, **LOOP)
    steps = LOOP["steps"]
    for rank in range(2):
        st = ranks[rank]["state"]
        assert st["extras"] == {"next_step": steps}
        pairs = list(zip(tree.leaves(st["restored"]),
                         tree.leaves(st["state"])))
        assert len(pairs) == 1 + 4 * len(tree.leaves(params))
        assert all(torch.equal(a, b) for a, b in pairs)
        # resumed from the blocks of the step before: bit for bit the
        # uninterrupted run
        assert st["resumed_losses"] == st["losses"][-1:]
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(st["resumed"]), tree.leaves(st["state"])))
        # int8 compression on blocks trains as the single rank does
        np.testing.assert_allclose(st["losses"], want, rtol=TOL, atol=0)
    # both ranks gathered the same global state; rank 0 alone keeps it
    for a, b in zip(tree.leaves(ranks[0]["state"]["whole"]),
                    tree.leaves(ranks[1]["state"]["whole"])):
        assert torch.equal(a, b)
    assert ranks[1]["state"]["kept"] is None
    kept = tree.leaves(ranks[0]["state"]["kept"])
    whole = tree.leaves(ranks[0]["state"]["whole"])
    assert len(kept) == len(whole)
    assert all(torch.equal(a, b) for a, b in zip(kept, whole))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_build_draws_the_blocks_of_the_single_rank_draws(arch):
    """Each slice of a leaf is cut to the rank's block as it is drawn:
    the blocks are those of the single rank's weights, bit for bit."""
    cfg = configs.get_config(arch, smoke=True)
    kw = dict(batch=2, seq=8, lr=1e-3, steps=1, device="cpu", seed=3)
    whole = port_train.build(cfg, **kw)[0].params
    halved = 0
    for rank in range(2):
        mesh = Mesh(("data", "model"), (2, 1), rank=rank)
        fsdp = port_step.fsdp_layout(cfg, mesh)
        state = port_train.build(cfg, mesh=mesh, **kw)[0]
        fsdp.check_blocks(state.params)
        want = tree.leaves(fsdp.place(whole))
        got = tree.leaves(state.params)
        assert len(got) == len(want)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
        halved += sum(a.shape != b.shape
                      for a, b in zip(got, tree.leaves(whole)))
    assert halved > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_a_mesh_of_one_rank_is_the_mesh_less_step(arch, masked):
    cfg = configs.get_config(arch, smoke=True)
    params_np = _jax(arch)[2]
    batch = {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v)
             for k, v in _batch(cfg, masked).items()}
    out = []
    for mesh in (None, Mesh(("data", "model"), (1, 1))):
        state = port_step.init_train_state(
            None, cfg, device="cpu",
            params=params_from_numpy(params_np, cfg, device="cpu"))
        if mesh is None:
            state, m = port_step.train_step(state, batch, cfg, lr=STEP_LR)
        else:
            with set_rules_for_mesh(mesh):
                state, m = port_step.train_step(state, batch, cfg,
                                                lr=STEP_LR)
        out.append((state, m))
    (a, ma), (b, mb) = out
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                  tree.leaves(b)))
    assert ma.keys() == mb.keys()
    assert all(torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k]))
               for k in ma)
