"""Tensor-parallel training of the port on a (2, 2) (data, model) mesh
of 4 gloo ranks (``launch.mesh.spawn``, one spawn for the file): the
GQA stacks on JAX's ``param_shardings`` (heads, KV heads, MLP columns,
vocabulary rows and experts over "model", ``embed`` over "data"), held
against the JAX package on the global batch (a mesh-less ``loss_fn``
and a 1-device ``train_loop`` have GSPMD's semantics), from JAX's
weights (``params_from_numpy``), for the smoke configs of starcoder2-7b,
qwen3-8b (qk-norm) and phi3.5-moe, and a starcoder2 variant of 6 query
heads over 3 KV heads, which stay whole on the model axis (each rank's
3 query heads part a KV group):

* one ``train_step``: the loss, the total and the MoE losses, and every
  gradient leaf gathered from its blocks, within 1e-5 of JAX's; the
  same on a masked batch whose data ranks hold 5 and 30 tokens
  (starcoder2, phi3.5-moe), under remat ``full`` (the same two), and
  under remat ``full`` with the backward (and so each layer's
  recompute) in a thread where the mesh's rules are unset, as the
  autograd engine runs a CUDA graph's backward (qwen3, phi3.5-moe);
* ``launch.train.train_loop``: the losses within 1e-5 relative of
  JAX's ``train_loop`` and of the port's single rank, the final
  parameters within 1e-5 of the single rank's but at most 1e-5 of the
  elements, which stay within a tenth of lr (a near-zero gradient's
  rounding, which AdamW's per-element normalisation amplifies: 1 of
  phi3.5-moe's 755,328 elements after three steps, 2 of qwen3's
  361,216 on the same check);
* each rank's blocks have ``shard_shape`` of ``param_shardings`` on the
  (2, 2) mesh, and its held parameter, gradient and optimizer bytes
  equal the dry-run's ``run_cell`` per-device figure there;
* the logits stay in vocabulary blocks: the step's counted all-gathers
  (``cost_analysis.count``) are the FSDP gathers of the parameters'
  data-axis blocks and the residual stream's sequence gathers
  (``seq_stream``) alone;
* a checkpoint saved from the (2, 2) blocks is restored with
  ``shardings=`` bit for bit (and a crashed run resumes bit for bit);
  ``runtime.remesh_state`` moves the (2, 2) state to (4, 1), every leaf
  bit-equal to the gathered blocks;
* MLA, Mamba-2 and jamba's hybrid split over the model axis too, on
  (2, 2) and (1, 2) (their training against JAX is
  ``tests/test_torch_tp_train_mla_ssm.py``'s).
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
from repro_torch.models.weights import param_axes, params_from_numpy
from repro_torch.sharding import param_shardings
from repro_torch.sharding.rules import local_slice, shard_shape, spec_axes
from repro_torch.train import step as port_step
from test_torch_mesh import SPAWN_TIMEOUT

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (2, 2)
FOUR = Mesh(("data", "model"), SHAPE)        # the ranks' mesh, shapes only
#: name -> (arch, config changes): the smoke configs, and starcoder2's
#: with 3 KV heads, whole on the model axis
CASES = {"starcoder2-7b": ("starcoder2-7b", {}),
         "qwen3-8b": ("qwen3-8b", {}),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
         "starcoder2-kv3": ("starcoder2-7b", dict(n_heads=6, n_kv_heads=3))}
MASKED = ["starcoder2-7b", "phi3.5-moe"]
LOOPS = ["starcoder2-7b", "phi3.5-moe"]
REMATS = ["starcoder2-7b", "phi3.5-moe"]
ELSEWHERE = ["qwen3-8b", "phi3.5-moe"]
COUNTED = ["starcoder2-7b", "qwen3-8b"]
STEPS = [(case, False) for case in CASES] + [(case, True) for case in MASKED]
LOOP = dict(steps=3, batch=4, seq=32, lr=1e-3)
STEP_B, STEP_S, STEP_LR = 4, 32, 1e-3
#: tokens per row of the masked batch: data rank 0's rows, then rank 1's
MASK_TOKENS = (2, 3, 14, 16)


@functools.lru_cache(maxsize=None)
def _cfg(case, remat=None):
    arch, kw = CASES[case]
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw)
    return cfg if remat is None else dataclasses.replace(cfg, remat=remat)


@functools.lru_cache(maxsize=None)
def _jax(case, remat=None):
    """(JAX cfg, JAX params, numpy params) of the case."""
    arch, kw = CASES[case]
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
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
    for case in ELSEWHERE:
        cfg = _cfg(case, "full")
        add(("elsewhere", case), mesh_ranks.grads_backward_elsewhere, cfg,
            _jax(case)[2], _torch_batch(cfg), SHAPE)
    for case in LOOPS:
        add(("loop", case), mesh_ranks.train_data_parallel, _cfg(case),
            _jax(case)[2], LOOP, SHAPE)
    add(("counted",), mesh_ranks.roofline_cells, [
        (CASES[case][0], "train_4k", dict(cfg=_cfg(case), mesh_shape=SHAPE,
                                          batch=STEP_B, seq=STEP_S))
        for case in COUNTED])
    case = "starcoder2-7b"
    add(("state",), mesh_ranks.fsdp_state, _cfg(case), _jax(case)[2], LOOP,
        str(tmp / "ckpt"), SHAPE)
    add(("remesh",), mesh_ranks.remesh_blocks, _cfg(case), _jax(case)[2],
        _torch_batch(_cfg(case)), STEP_LR, SHAPE, (4, 1))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, 4, mesh_ranks.in_turn, backend="gloo",
                            devices=["cpu"] * 4, init_file=str(tmp / "init"),
                            args=(calls,), timeout=SPAWN_TIMEOUT)
        # the references, while the ranks run
        for case, masked in STEPS:
            _jax_step(case, masked)
        for case in set(REMATS) | set(ELSEWHERE):
            _jax_step(case, False, "full")
        for case in LOOPS:
            _loops(case)
        out = ranks.result()
    return [dict(zip(keys, r)) for r in out]


def _grads_close(got, want):
    """Every gradient leaf within TOL of its largest magnitude."""
    jl = [np.asarray(x) for x in jax.tree.leaves(want)]
    gl = tree.leaves(got)
    assert len(jl) == len(gl)
    for w, g in zip(jl, gl):
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * max(np.abs(w).max(), 1e-30), (w.shape, err)


@functools.lru_cache(maxsize=None)
def _jax_step(case, masked, remat=None):
    jcfg, jparams, _ = _jax(case, remat)
    batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(case),
                                                  masked).items()}
    return jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, batch), has_aux=True)(jparams)


@pytest.mark.parametrize("case,masked", STEPS)
def test_one_step_matches_jax_on_the_global_batch(ranks, case, masked):
    """Loss, total, MoE losses and every gradient leaf, a leaf whole on
    the model axis (the norms, the router's data-only dims, the KV
    heads of the 3-head variant) among them."""
    (jtot, jm), jgrads = _jax_step(case, masked)
    for rank in range(4):
        got = ranks[rank][("step", case, masked)]
        m = got["metrics"]
        for key in ("loss", "moe_lb_loss", "moe_z_loss"):
            assert m[key] == pytest.approx(float(jm[key]), rel=TOL,
                                           abs=0 if float(jm[key]) else 1e-12)
        total = m["loss"] + 0.01 * m["moe_lb_loss"] + 0.001 * m["moe_z_loss"]
        assert total == pytest.approx(float(jtot), rel=TOL)
        _grads_close(got["grads"], jgrads)
    if case.startswith("phi"):
        assert float(jm["moe_lb_loss"]) > 0


@pytest.mark.parametrize("case", REMATS)
def test_one_step_under_remat_full_matches_jax(ranks, case):
    (jtot, jm), jgrads = _jax_step(case, False, "full")
    for rank in range(4):
        got = ranks[rank][("remat", case)]
        assert got["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                       rel=TOL)
        _grads_close(got["grads"], jgrads)


@pytest.mark.parametrize("case", ELSEWHERE)
def test_recompute_outside_the_rules_thread_matches_jax(ranks, case):
    """The backward run in another thread, whose mesh rules are unset,
    as the autograd engine runs a CUDA graph's: each checkpointed layer
    recomputes under the forward's mesh (its output partials summed,
    the MoE load balance from global means), so the gradients are
    JAX's."""
    (jtot, jm), jgrads = _jax_step(case, False, "full")
    for rank in range(4):
        _grads_close(ranks[rank][("elsewhere", case)]["grads"], jgrads)


@functools.lru_cache(maxsize=None)
def _loops(case):
    """(the port's single-rank ``train_loop``: state and losses, JAX's
    losses) from JAX's seed-0 weights."""
    cfg = _cfg(case)
    jcfg, _, params_np = _jax(case)
    state, losses = port_train.train_loop(
        cfg, params=params_from_numpy(params_np, cfg, device="cpu"),
        device="cpu", **LOOP)
    _, want = jax_train.train_loop(jcfg, mesh=jax_host_mesh(1, 1), **LOOP)
    return state, losses, want


@pytest.mark.parametrize("case", LOOPS)
def test_train_loop_matches_jax_and_one_rank(ranks, case):
    state, losses, want = _loops(case)
    n = sum(x.numel() for x in tree.leaves(state.params))
    for rank in range(4):
        got = ranks[rank][("loop", case)]
        np.testing.assert_allclose(got["losses"], want, rtol=TOL, atol=0)
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=0)
        over, worst = 0, 0.0
        for a, b in zip(tree.leaves(got["params"]),
                        tree.leaves(state.params)):
            assert a.shape == b.shape
            d = (a - b).abs()
            over += int((d > TOL).sum())
            worst = max(worst, float(d.max()))
        # AdamW divides each element's moment by its root mean square,
        # so an element whose gradient is a near-cancelled sum (qk-norm's
        # wq, a rarely routed expert's) turns the layouts' rounding into
        # a fraction of lr: at most 1e-5 of the elements beyond TOL
        assert over <= 1e-5 * n and worst <= 0.1 * LOOP["lr"], (over, worst)


@pytest.mark.parametrize("case", LOOPS)
def test_each_rank_holds_its_model_and_data_blocks(ranks, case):
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
    # every model-axis dim of the smoke configs divides 2
    assert any("model" in spec_axes(e) for s in specs for e in s)
    assert any("data" in spec_axes(e) for s in specs for e in s)
    for rank in range(4):
        got = ranks[rank][("loop", case)]
        assert tree.leaves(got["block_shapes"],
                           is_leaf=lambda t: isinstance(t, tuple)) == blocks
        assert got["held"] == {"params": cell["params"],
                               "grads": cell["params"],
                               "optimizer": cell["optimizer"]}
        assert got["held"]["params"] == block_bytes
    # the 3 KV heads stay whole on the model axis
    kv3 = param_shardings(param_axes(_cfg("starcoder2-kv3")), FOUR,
                          like=params_from_numpy(_jax("starcoder2-kv3")[2],
                                                 _cfg("starcoder2-kv3"),
                                                 device="cpu"))
    attn = kv3["layers"][0]["attn"]
    assert attn["wk"].spec[2] is None and attn["wq"].spec[2] == "model"


def _data_gather_bytes(cfg) -> int:
    """The all-gathers of one step at remat none: each use of a leaf (a
    stacked leaf's period, once a layer) with a data axis in its spec
    gathers its model-axis block whole over the data axis."""
    fsdp = port_step.fsdp_layout(cfg, FOUR)
    params = port_step.init_params(cfg, None, "meta")
    total = 0
    for key in params:
        for spec, x in zip(tree.leaves(fsdp.param_specs[key],
                                       is_leaf=lambda t: isinstance(t, tuple)),
                           tree.leaves(params[key])):
            if not any("data" in spec_axes(e) for e in spec):
                continue
            model = tuple(e if "model" in spec_axes(e) else None
                          for e in spec)
            total += math.prod(shard_shape(x.shape, model, FOUR)) \
                * x.element_size()
    return total


def _sequence_gather_bytes(cfg) -> int:
    """The residual stream's all-gathers of one step at remat none
    (``seq_stream``: the stream is each rank's S/2 rows): forward, each
    layer's two normed sublayer inputs and the final norm's output;
    backward, the transposes of the reduce-scatters of each layer's two
    sublayer outputs and of the embedding's rows; each the data rank's
    whole (B/2, S, d) rows in the compute dtype."""
    rows = STEP_B // SHAPE[0] * STEP_S
    one = rows * cfg.d_model * cfg.torch_dtype().itemsize
    return (2 * cfg.n_layers + 1) * 2 * one


def test_logits_stay_in_vocabulary_blocks(ranks):
    """The step gathers nothing but the parameters' data-axis blocks and
    the residual stream's sequence blocks: no logits (4 x 32 x 256 fp32)
    over the vocabulary."""
    for case, got in zip(COUNTED, ranks[0][("counted",)]):
        cfg = _cfg(case)
        assert cfg.remat == "none"
        gathered = got["collective_bytes"]["all-gather"]
        assert gathered == _data_gather_bytes(cfg) \
            + _sequence_gather_bytes(cfg), case
        assert "over the 2 ranks of its model axis: heads, kv_heads, " \
            "mlp, vocab" in got["layout"]


def test_checkpoint_of_blocks_round_trips_bitwise(ranks):
    cfg = _cfg("starcoder2-7b")
    params = params_from_numpy(_jax("starcoder2-7b")[2], cfg, device="cpu")
    _, want = port_train.train_loop(cfg, params=params, device="cpu",
                                    grad_compression=True, **LOOP)
    for rank in range(4):
        st = ranks[rank][("state",)]
        assert st["extras"] == {"next_step": LOOP["steps"]}
        pairs = list(zip(tree.leaves(st["restored"]),
                         tree.leaves(st["state"])))
        assert len(pairs) == 1 + 4 * len(tree.leaves(params))
        assert all(torch.equal(a, b) for a, b in pairs)
        assert st["resumed_losses"] == st["losses"][-1:]
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(st["resumed"]), tree.leaves(st["state"])))
        # int8 compression on model- and data-axis blocks
        np.testing.assert_allclose(st["losses"], want, rtol=TOL, atol=0)
        blocks, whole = st["norm"]
        assert blocks == pytest.approx(whole, rel=1e-6)
        assert st["scales"][0] == st["scales"][1]
    for a, b in zip(tree.leaves(ranks[0][("state",)]["whole"]),
                    tree.leaves(ranks[3][("state",)]["whole"])):
        assert torch.equal(a, b)


def test_remesh_moves_the_blocks_to_another_mesh(ranks):
    """(2, 2) -> (4, 1): each rank's new blocks are its blocks of the
    state gathered from the (2, 2) blocks, bit for bit."""
    cfg = _cfg("starcoder2-7b")
    like = params_from_numpy(_jax("starcoder2-7b")[2], cfg, device="cpu")
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


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_mla_and_mamba_keep_the_data_only_layout(arch):
    """No stack keeps a data-only layout any more: MLA's heads,
    Mamba-2's ``inner``, ``ssm_heads`` and conv channels, the MLP's
    columns, the experts and the vocabulary rows are blocks over
    "model" on (2, 2) and (1, 2), as for the GQA stacks; the latent,
    the conv width and the SSM state stay whole."""
    cfg = configs.get_config(arch, smoke=True)
    for shape in (SHAPE, (1, 2)):
        fsdp = port_step.fsdp_layout(cfg, Mesh(("data", "model"), shape))
        assert fsdp.model_ranks == 2
        specs = tree.leaves(fsdp.param_specs,
                            is_leaf=lambda t: isinstance(t, tuple))
        axes = tree.leaves(param_axes(cfg),
                           is_leaf=lambda t: isinstance(t, tuple))
        split = {name for ax, spec in zip(axes, specs)
                 for name, e in zip(ax, spec) if "model" in spec_axes(e)}
        assert "vocab" in split
        assert not {"latent", "conv", "ssm_state"} & split
        if cfg.attention == "mla":
            assert {"heads", "experts", "mlp"} <= split
        if cfg.ssm_heads:
            assert {"inner", "ssm_heads"} <= split
        if shape == SHAPE:
            assert any("data" in spec_axes(e) for s in specs for e in s)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_build_draws_the_model_blocks_of_the_single_rank_draws(arch):
    """On (2, 2) and (1, 2) each slice of a leaf is cut to the rank's
    block (its model-axis block too) as it is drawn:
    the blocks of the single rank's weights, bit for bit, so a mesh's
    run starts from the single rank's model."""
    cfg = configs.get_config(arch, smoke=True)
    kw = dict(batch=2, seq=8, lr=1e-3, steps=1, device="cpu", seed=3)
    whole = port_train.build(cfg, **kw)[0].params
    for shape in (SHAPE, (1, 2)):
        split = 0
        for rank in range(math.prod(shape)):
            mesh = Mesh(("data", "model"), shape, rank=rank)
            fsdp = port_step.fsdp_layout(cfg, mesh)
            state = port_train.build(cfg, mesh=mesh, **kw)[0]
            fsdp.check_blocks(state.params)
            want = tree.leaves(fsdp.place(whole))
            got = tree.leaves(state.params)
            assert len(got) == len(want)
            assert all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want))
            split += sum(a.shape != b.shape
                         for a, b in zip(got, tree.leaves(whole)))
        assert split > 0
