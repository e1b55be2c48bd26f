"""The Mixture-of-Experts slice against the JAX package, on the same
weights (``params_from_numpy`` of ``init_params_and_axes(PRNGKey(0))``,
or of ``repro.models.moe.init_moe``) and the same numpy inputs, in fp32
on the CPU:

* ``models.moe.moe_forward`` against ``repro.models.moe.moe_forward`` on
  phi3.5-moe's and deepseek-v3's smoke MoE (deepseek: 8 experts, top-2,
  one shared expert), B=2, S=64: the output within 1e-5 of its largest
  magnitude (the experts' fan-in scale 1/sqrt(E) makes outputs of
  order 100) and both aux losses within 1e-6 relative (fp32 means of
  128 terms of order 1 round at that), at the config's capacity
  factor, at 0.5 (copies dropped to the sentinel slot), with
  ``moe_group_size=32`` and with a zero router, where every token ties
  across every expert (JAX's ``top_k`` order: experts 0..k-1);
* the phi3.5 smoke model's logits within 1e-4 and its aux losses within
  1e-6 relative, also with a dense prefix and with a shared expert;
* ``init_params``' tree against the JAX tree (structure, shapes,
  dtypes; the router fp32 under bf16 parameters);
* ``train_step``'s loss, aux losses and every gradient leaf within 1e-5
  of JAX's under each remat policy, the policies' gradients equal (1e-6
  of each leaf's largest), ``dots`` keeping each layer's projections
  and router product (``aten.mm``) and recomputing the experts
  (``aten.bmm``), and ``launch.train.train_loop``'s losses.

The engines' token streams are in tests/test_torch_moe_serve.py.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.models import common as jax_cm
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.launch import train as port_train
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCH = "phi3.5-moe-42b-a6.6b"
MODULE_ARCHS = [ARCH, "deepseek-v3-671b"]
MODULE_TOL, AUX_TOL, ATOL = 1e-5, 1e-6, 1e-4
#: train_step's tolerance: loss relative, each gradient leaf against its
#: largest magnitude
TRAIN_TOL = 1e-5


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _weights(**over):
    """(port cfg, JAX cfg, JAX params, port params) of phi3.5's smoke
    config with ``over`` replaced."""
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **over)
    return cfg, jcfg, jparams, params_from_numpy(_np_tree(jparams), cfg,
                                                 device="cpu")


def test_config_matches_jax_and_registers():
    for smoke in (False, True):
        assert dataclasses.asdict(configs.get_config(ARCH, smoke)) == \
            dataclasses.asdict(jax_configs.get_config(ARCH, smoke))
    assert configs.family(ARCH) == "moe"
    assert configs.list_archs("moe") == [ARCH]
    assert ARCH not in configs.list_archs("dense")
    assert ARCH in port_train.parser()._option_string_actions[
        "--arch"].choices
    tf.check_ported(configs.get_config(ARCH))


@pytest.mark.parametrize("tokens", [1, 7, 64, 256, 2048, 4096])
@pytest.mark.parametrize("arch", MODULE_ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5, 1.25])
def test_capacity_equals_jax(arch, tokens, cf):
    jcfg = jax_configs.get_config(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    got = moe.capacity(_port_cfg(jcfg), tokens)
    assert got == jax_moe._capacity(jcfg, tokens)
    assert isinstance(got, int) and got % 8 == 0 and got >= 8


def test_top_k_keeps_jax_tie_order():
    """Equal probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` orders them."""
    rows = np.array([[1 / 16] * 16, [0.1, 0.3, 0.3, 0.3] + [0.0] * 12,
                     [0.2, 0.1, 0.2, 0.5] + [0.0] * 12], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        v, i = moe.top_k(torch.from_numpy(rows), k)
        assert i.tolist() == np.asarray(ji).tolist()
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _module(arch, case):
    """(port cfg, JAX cfg, JAX MoE params, port MoE params, x) of one
    module case."""
    jcfg = jax_configs.get_config(arch, smoke=True)
    if case == "drop":
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    elif case == "grouped":
        jcfg = dataclasses.replace(jcfg, moe_group_size=32)
    jp, _ = jax_cm.split_params(jax_moe.init_moe(jax.random.PRNGKey(3),
                                                 jcfg))
    if case == "zero_router":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    cfg = _port_cfg(jcfg)
    x = np.random.default_rng(11).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    # moe_forward reads no attention field: deepseek's MLA, which the
    # model refuses, stays out of the leaves' conversion
    params = params_from_numpy(
        _np_tree(jp), dataclasses.replace(cfg, attention="gqa"), "cpu")
    return cfg, jcfg, jp, params, x


@pytest.mark.parametrize("case", ["config", "drop", "grouped",
                                  "zero_router"])
@pytest.mark.parametrize("arch", MODULE_ARCHS)
def test_moe_forward_matches_jax(arch, case):
    cfg, jcfg, jp, params, x = _module(arch, case)
    want, jaux = jax_moe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(params, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        MODULE_TOL * np.abs(want).max()
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert aux[key].dtype == torch.float32 and aux[key].ndim == 0
        assert float(aux[key]) == pytest.approx(float(jaux[key]),
                                                rel=AUX_TOL), key
    k, e = cfg.top_k, cfg.n_experts
    assert ("shared" in params) == (cfg.n_shared_experts > 0)

    groups = torch.from_numpy(
        x.reshape(-1, cfg.moe_group_size, cfg.d_model)
        if case == "grouped" else x)
    _, probs, _, topi = moe.route(params["router"], groups, k)
    assert topi.shape[-1] == k and probs.shape[-1] == e
    cap = moe.capacity(cfg, groups.shape[1])
    _, slot, _ = moe._dispatch(groups, topi, cap, e)
    dropped = int((slot == e * cap).sum())
    if case == "drop":
        assert dropped > 0
    else:
        assert dropped == 0
    if case == "grouped":
        assert topi.shape[:2] == (4, 32)
    if case == "zero_router":
        assert (topi == torch.arange(k)).all()
        assert float(jaux["moe_z_loss"]) == pytest.approx(np.log(e) ** 2)


def test_dispatch_places_every_kept_copy_once():
    """Each kept copy sits at its expert's next free slot, in token
    order within the expert; the dropped copies are the latest ones."""
    cfg = configs.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(5)
    topi = torch.from_numpy(np.stack([
        rng.permutation(cfg.n_experts)[:cfg.top_k] for _ in range(40)]
    )).reshape(1, 40, cfg.top_k)
    x = torch.arange(40, dtype=torch.float32).reshape(1, 40, 1)
    cap = 8
    buf, slot, order = moe._dispatch(x, topi, cap, cfg.n_experts)
    for ex in range(cfg.n_experts):
        toks = [t for t in range(40) if ex in topi[0, t].tolist()]
        kept = toks[:cap]
        assert buf[0, ex, :len(kept), 0].tolist() == kept
        assert (buf[0, ex, len(kept):] == 0).all()
    assert int((slot == cfg.n_experts * cap).sum()) == sum(
        max(0, int((topi == ex).sum()) - cap)
        for ex in range(cfg.n_experts))


@pytest.mark.parametrize("over", [
    {}, {"first_dense_layers": 1, "n_layers": 3}, {"n_shared_experts": 1}],
    ids=["moe", "dense_prefix", "shared_expert"])
def test_forward_logits_and_aux_match_jax(over):
    cfg, jcfg, jparams, params = _weights(**over)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, jaux = jax_tf.forward(jparams, jcfg, jnp.asarray(toks),
                                return_aux=True)
    got, aux = tf.forward(params, cfg, torch.from_numpy(toks).long(),
                          return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]),
                                                rel=AUX_TOL), key
    assert len(params["prefix_layers"]) == cfg.first_dense_layers
    if cfg.first_dense_layers:
        assert "mlp" in params["prefix_layers"][0]
        assert "moe" in params["layers"][0]


@pytest.mark.parametrize("over", [
    {}, {"first_dense_layers": 1, "n_layers": 3},
    {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"},
    {"n_shared_experts": 2}],
    ids=["smoke", "dense_prefix", "bf16", "shared_experts"])
def test_init_params_tree_matches_jax(over):
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **over)
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == np.asarray(b).dtype.name
    router = mine["layers"][0]["moe"]["router"]
    assert router.dtype == torch.float32
    # JAX's fan-in rule: shape[0], the expert count for an expert leaf
    w = mine["layers"][0]["moe"]["w_gate"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.n_experts) + 1e-6
    assert float(w.std()) > 0.5 / np.sqrt(cfg.n_experts)
    bf16 = params_from_numpy(_np_tree(jparams), cfg, "cpu",
                             dtype=torch.bfloat16)
    assert bf16["layers"][0]["moe"]["router"].dtype == torch.float32
    assert bf16["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16


def _batch(cfg, b=2, s=33, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _grads(cfg, params, toks):
    (tot, m), grads = port_step.value_and_grad(
        params, cfg, {"tokens": torch.from_numpy(toks).long()})
    return tot, m, grads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_matches_jax_under_each_remat(remat):
    cfg, jcfg, jparams, params = _weights(remat=remat)
    toks = _batch(cfg)
    (jtot, jm), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    tot, m, grads = _grads(cfg, params, toks)
    assert float(tot) == pytest.approx(float(jtot), rel=TRAIN_TOL)
    for key in ("loss", "moe_lb_loss", "moe_z_loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]),
                                              rel=TRAIN_TOL), key
        assert not m[key].requires_grad
    assert float(m["moe_lb_loss"]) > 0 and float(m["moe_z_loss"]) > 0
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= TRAIN_TOL * scale

    # the same gradients under every policy (the embedding's gradient
    # accumulates repeated tokens in a thread-dependent order on the CPU,
    # so leaves are held to 1e-6 of their largest, as in
    # tests/test_torch_remat.py)
    _, _, ref = _grads(dataclasses.replace(cfg, remat="none"), params, toks)
    for a, b in zip(tree.leaves(grads), tree.leaves(ref)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_moe_products_reach_mm_for_the_router_and_bmm_for_experts():
    """The router's ``x @ router`` folds to one ``aten.mm`` (no batch
    dimension: ``dots`` keeps it); the three expert products are
    ``aten.bmm`` over the experts and the combine no product at all
    (``dots`` recomputes them, as JAX's policy does)."""
    cfg, _, _, params = _weights()
    lp = {k: v[0] for k, v in params["layers"][0]["moe"].items()}
    x = torch.randn(2, 9, cfg.d_model, requires_grad=True)
    with _Ops() as mode:
        moe.moe_forward(lp, cfg, x)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert mode.seen.count(mm) == 1 and mode.seen.count(bmm) == 3
    assert tf.dots_policy(None, mm) == tf.CheckpointPolicy.MUST_SAVE
    assert tf.dots_policy(None, bmm) == \
        tf.CheckpointPolicy.PREFER_RECOMPUTE


def _sac_kept():
    """Shapes of the tensors the selective checkpoints hold for the
    backward (their storage's wrapped entries, found by the collector)."""
    from torch.utils.checkpoint import _VersionWrapper
    return sorted(tuple(o.val.shape) for o in gc.get_objects()
                  if type(o) is _VersionWrapper
                  and isinstance(o.val, torch.Tensor))


def test_dots_keeps_the_projections_and_the_router_product():
    """Under ``dots`` each MoE layer keeps its q/k/v/o projections and
    its router logits (rows, E), nothing of the experts."""
    cfg, _, _, params = _weights(remat="dots")
    toks = _batch(cfg)
    rows = toks.shape[0] * (toks.shape[1] - 1)
    leaves = port_step._trainable(params, tree.map(torch.zeros_like,
                                                   params))
    gc.collect()
    assert _sac_kept() == []
    with torch.enable_grad():
        total, _ = port_step.loss_fn(
            leaves, cfg, {"tokens": torch.from_numpy(toks).long()})
    h, hk, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    layer = [(rows, h * d), (rows, hk * d), (rows, hk * d),
             (rows, cfg.d_model), (rows, cfg.n_experts)]
    assert _sac_kept() == sorted(layer * cfg.n_layers)
    total.backward()
    del total
    gc.collect()
    assert _sac_kept() == []


def test_aux_terms_reach_the_router_gradient(monkeypatch):
    """The load-balance and z-loss terms enter the total: the router's
    gradient changes when they are dropped from the loss."""
    cfg, _, _, params = _weights()
    toks = _batch(cfg)
    _, m, grads = _grads(cfg, params, toks)
    orig = tf.forward

    def no_aux(*a, **kw):
        logits, aux = orig(*a, **kw)
        return logits, {k: v * 0 for k, v in aux.items()}

    monkeypatch.setattr(tf, "forward", no_aux)
    _, m0, bare = _grads(cfg, params, toks)
    r, r0 = (g["layers"][0]["moe"]["router"] for g in (grads, bare))
    assert not torch.equal(r, r0)
    assert float(m0["loss"]) == float(m["loss"])


def test_train_loop_losses_match_jax():
    cfg, jcfg, _, params = _weights()
    kw = dict(steps=4, batch=2, seq=24, lr=1e-3, log_every=100)
    _, want = jax_train.train_loop(jcfg, **kw)
    _, got = port_train.train_loop(cfg, device="cpu", params=params, **kw)
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
