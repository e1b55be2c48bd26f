"""Tensor-parallel training of MLA, Mamba-2 and jamba's hybrid on a
(2, 2) (data, model) mesh of 4 gloo ranks (``launch.mesh.spawn``, one
spawn for the file), on JAX's ``param_shardings`` (MLA's heads, Mamba-2's
``in_proj`` columns, conv channels, ``inner`` and ``ssm_heads``, the MLP
columns, the experts and the vocabulary rows over "model", ``embed``
over "data"), held against the JAX package on the global batch (a
mesh-less ``loss_fn`` and a 1-device ``train_loop`` have GSPMD's
semantics), from JAX's weights (``params_from_numpy``), for the smoke
configs of deepseek-v3 (4 heads, 8 experts, a dense prefix layer, a
shared expert), mamba2-130m and jamba-1.5, and a mamba2 variant of 3
SSM heads of 64 whose ``in_proj`` (451 columns) and SSM heads stay
whole on the model axis while its 256 conv channels and its ``inner``
of 192 split (mamba2-130m's layout on 16 ranks of "model"):

* one ``train_step``: the loss, the total and the MoE losses, and every
  gradient leaf gathered from its blocks, within 1e-5 of JAX's (jamba's
  5e-5, as its single-rank test holds it); the same on a masked batch
  whose data ranks hold 5 and 30 tokens (deepseek-v3, the mamba2
  variant), and under remat ``full`` (deepseek-v3, jamba);
* ``launch.train.train_loop``: the losses within 1e-5 relative of
  JAX's ``train_loop`` and of the port's single rank (deepseek-v3,
  mamba2);
* each rank's blocks have ``shard_shape`` of ``param_shardings`` on the
  (2, 2) mesh, and its held parameter, gradient and optimizer bytes
  equal the dry-run's ``run_cell`` per-device figure there;
* ``runtime.remesh_state`` moves jamba's (2, 2) state to (4, 1), every
  leaf bit-equal to the gathered blocks.

The JAX references are computed in the parent while the ranks run.
"""

import concurrent.futures
import dataclasses
import functools
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
from repro_torch.models.mamba import dims
from repro_torch.models.weights import param_axes, params_from_numpy
from repro_torch.sharding import param_shardings
from repro_torch.sharding.rules import local_slice, shard_shape, spec_axes
from test_torch_mesh import SPAWN_TIMEOUT

torch.set_num_threads(1)

SHAPE = (2, 2)
FOUR = Mesh(("data", "model"), SHAPE)        # the ranks' mesh, shapes only
#: name -> (arch, config changes, tolerance)
CASES = {"deepseek-v3": ("deepseek-v3-671b", {}, 1e-5),
         "mamba2": ("mamba2-130m", {}, 1e-5),
         "jamba": ("jamba-1.5-large-398b", {}, 5e-5),
         "mamba2-h3": ("mamba2-130m", dict(ssm_heads=3, d_inner=192), 1e-5)}
MASKED = ["deepseek-v3", "mamba2-h3"]
REMATS = ["deepseek-v3", "jamba"]
LOOPS = ["deepseek-v3", "mamba2"]
STEPS = [(case, False) for case in CASES] + [(case, True) for case in MASKED]
LOOP = dict(steps=3, batch=4, seq=32, lr=1e-3)
STEP_B, STEP_S, STEP_LR = 4, 32, 1e-3
#: tokens per row of the masked batch: data rank 0's rows, then rank 1's
MASK_TOKENS = (2, 3, 14, 16)


@functools.lru_cache(maxsize=None)
def _cfg(case, remat=None):
    arch, kw, _ = CASES[case]
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw)
    return cfg if remat is None else dataclasses.replace(cfg, remat=remat)


@functools.lru_cache(maxsize=None)
def _jax(case, remat=None):
    """(JAX cfg, JAX params, numpy params) of the case."""
    arch, kw, _ = CASES[case]
    jcfg = dataclasses.replace(jax_configs.get_config(arch, smoke=True),
                               **kw)
    if remat is not None:
        jcfg = dataclasses.replace(jcfg, remat=remat)
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


def _torch_batch(cfg, masked=False):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg, masked).items()}


def test_the_variant_parts_in_proj_from_the_conv_and_inner():
    """The mixed layout: ``in_proj`` and the SSM heads whole on the
    model axis, the conv channels and ``inner`` split."""
    cfg = _cfg("mamba2-h3")
    d_in, h, p, g, s = dims(cfg)
    assert (2 * d_in + 2 * g * s + h, d_in + 2 * g * s, d_in, h) == \
        (451, 256, 192, 3)
    like = params_from_numpy(_jax("mamba2-h3")[2], cfg, device="cpu")
    mamba = param_shardings(param_axes(cfg), FOUR,
                            like=like)["layers"][0]["mamba"]
    assert "model" not in spec_axes(mamba["in_proj"].spec[2])
    assert "model" not in spec_axes(mamba["a_log"].spec[1])
    assert mamba["conv_w"].spec[2] == "model"
    assert mamba["out_proj"].spec[1] == "model"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train_mla_ssm")
    calls, keys = [], []

    def add(key, body, *args):
        keys.append(key)
        calls.append((body, args))

    for case, masked in STEPS:
        cfg = _cfg(case)
        add(("step", case, masked), mesh_ranks.train_step_on_mesh, cfg,
            _jax(case)[2], _torch_batch(cfg, masked), STEP_LR, SHAPE)
    for case in REMATS:
        cfg = _cfg(case, "full")
        add(("remat", case), mesh_ranks.train_step_on_mesh, cfg,
            _jax(case)[2], _torch_batch(cfg), STEP_LR, SHAPE)
    for case in LOOPS:
        add(("loop", case), mesh_ranks.train_data_parallel, _cfg(case),
            _jax(case)[2], LOOP, SHAPE)
    case = "jamba"
    add(("remesh",), mesh_ranks.remesh_blocks, _cfg(case), _jax(case)[2],
        _torch_batch(_cfg(case)), STEP_LR, SHAPE, (4, 1))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(spawn, 4, mesh_ranks.in_turn, backend="gloo",
                            devices=["cpu"] * 4, init_file=str(tmp / "init"),
                            args=(calls,), timeout=SPAWN_TIMEOUT)
        # the references, while the ranks run: the loops in a thread of
        # their own (XLA compiles outside the interpreter lock)
        loops = pool.submit(lambda: [_loops(case) for case in LOOPS])
        for case, masked in STEPS:
            _jax_step(case, masked)
        for case in REMATS:
            _jax_step(case, False, "full")
        loops.result()
        out = ranks.result()
    return [dict(zip(keys, r)) for r in out]


def _grads_close(got, want, tol):
    """Every gradient leaf within ``tol`` of its largest magnitude."""
    jl = [np.asarray(x) for x in jax.tree.leaves(want)]
    gl = tree.leaves(got)
    assert len(jl) == len(gl)
    for w, g in zip(jl, gl):
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (w.shape, err)


@functools.lru_cache(maxsize=None)
def _jax_step(case, masked, remat=None):
    jcfg, jparams, _ = _jax(case, remat)
    batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(case),
                                                  masked).items()}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_step.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)


@pytest.mark.parametrize("case,masked", STEPS)
def test_one_step_matches_jax_on_the_global_batch(ranks, case, masked):
    """Loss, total, MoE losses and every gradient leaf: the leaves whole
    on the model axis (MLA's ``wq_a``/``wkv_a`` and their norms, whose
    cotangents are each rank's heads' shares; the variant's
    ``in_proj`` and SSM heads; the norms) among them."""
    tol = CASES[case][2]
    (jtot, jm), jgrads = _jax_step(case, masked)
    for rank in range(4):
        got = ranks[rank][("step", case, masked)]
        m = got["metrics"]
        for key in ("loss", "moe_lb_loss", "moe_z_loss"):
            assert m[key] == pytest.approx(float(jm[key]), rel=tol,
                                           abs=0 if float(jm[key]) else 1e-12)
        total = m["loss"] + 0.01 * m["moe_lb_loss"] + 0.001 * m["moe_z_loss"]
        assert total == pytest.approx(float(jtot), rel=tol)
        _grads_close(got["grads"], jgrads, tol)
    if _cfg(case).moe:
        assert float(jm["moe_lb_loss"]) > 0


@pytest.mark.parametrize("case", REMATS)
def test_one_step_under_remat_full_matches_jax(ranks, case):
    tol = CASES[case][2]
    (jtot, jm), jgrads = _jax_step(case, False, "full")
    for rank in range(4):
        got = ranks[rank][("remat", case)]
        assert got["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                       rel=tol)
        _grads_close(got["grads"], jgrads, tol)


@functools.lru_cache(maxsize=None)
def _loops(case):
    """(the port's single-rank ``train_loop`` losses, JAX's) from JAX's
    seed-0 weights."""
    cfg = _cfg(case)
    jcfg, _, params_np = _jax(case)
    _, losses = port_train.train_loop(
        cfg, params=params_from_numpy(params_np, cfg, device="cpu"),
        device="cpu", **LOOP)
    _, want = jax_train.train_loop(jcfg, mesh=jax_host_mesh(1, 1), **LOOP)
    return losses, want


@pytest.mark.parametrize("case", LOOPS)
def test_train_loop_matches_jax_and_one_rank(ranks, case):
    losses, want = _loops(case)
    for rank in range(4):
        got = ranks[rank][("loop", case)]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_model_and_data_blocks(ranks, case):
    """The blocks' shapes are ``shard_shape`` of ``param_shardings``,
    and the parameter, gradient and optimizer bytes a rank holds are
    ``run_cell``'s per-device figure on (2, 2)."""
    cfg = _cfg(case)
    params = params_from_numpy(_jax(case)[2], cfg, device="cpu")
    specs = [s.spec for s in tree.leaves(
        param_shardings(param_axes(cfg), FOUR, like=params))]
    blocks = [shard_shape(x.shape, s, FOUR)
              for x, s in zip(tree.leaves(params), specs)]
    block_bytes = sum(math.prod(b) * x.element_size()
                      for b, x in zip(blocks, tree.leaves(params)))
    cell = dryrun.run_cell(CASES[case][0], "train_4k", cfg=cfg, mesh=FOUR,
                           moment_dtype="float32",
                           costs=False)["per_device_bytes"]
    assert any("model" in spec_axes(e) for s in specs for e in s)
    assert any("data" in spec_axes(e) for s in specs for e in s)
    for rank in range(4):
        got = ranks[rank][("step", case, False)]
        assert tree.leaves(got["block_shapes"],
                           is_leaf=lambda t: isinstance(t, tuple)) == blocks
        assert got["held"] == {"params": cell["params"],
                               "grads": cell["params"],
                               "optimizer": cell["optimizer"]}
        assert got["held"]["params"] == block_bytes


def test_remesh_moves_jambas_blocks_to_another_mesh(ranks):
    """(2, 2) -> (4, 1): each rank's new blocks are its blocks of the
    state gathered from the (2, 2) blocks, bit for bit."""
    cfg = _cfg("jamba")
    like = params_from_numpy(_jax("jamba")[2], cfg, device="cpu")
    whole = ranks[0][("remesh",)]["whole"]
    split = 0
    for rank in range(4):
        new = Mesh(("data", "model"), (4, 1), rank=rank)
        specs = tree.leaves(param_shardings(param_axes(cfg), new, like=like))
        got = ranks[rank][("remesh",)]
        for key in ("params", "mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(
                tree.leaves(got["whole"][key]), tree.leaves(whole[key])))
            for x, want, s in zip(tree.leaves(got["moved"][key]),
                                  tree.leaves(whole[key]), specs):
                assert torch.equal(x, local_slice(want, s.spec, new))
                split += x.shape != want.shape
    assert split > 0
