"""MLA training of the port against the JAX package: deepseek-v3's
cache-free attention (per-head K/V, D = nope + rope, Dv = v) through the
differentiable training attention (#7-#9's plain versions on the CPU),
in fp32, with weights shared through ``params_from_numpy`` of
``init_params_and_axes(PRNGKey(0))`` and token batches made with numpy
from a seed:

* ``train_step``'s loss, ``moe_lb_loss``, ``moe_z_loss`` and every
  gradient leaf against ``jax.value_and_grad`` of the JAX ``loss_fn``
  under remat ``none``, ``full`` and ``dots``, within TRAIN_TOL (loss
  relative, each leaf against its largest magnitude), on
  ``deepseek-v3-smoke`` (one dense-prefix layer, two MoE layers with a
  shared expert) and on its dense variant (2 layers, no prefix, no MoE:
  the form in which the card trains deepseek-v3's dense layers); each
  policy's gradients equal ``none``'s within 1e-6 of each leaf's
  largest;
* what ``dots`` keeps for the backward: exactly each layer's six MLA
  projections and its FFN's products (``aten.mm``);
* the cache-free branch hands the attention a contiguous K (the
  concatenation of the nope part and the rope key broadcast over the
  heads), so its wrapper copies nothing;
* two ``launch.train.train_loop`` steps' losses against JAX's;
* a depth that is only the dense prefix, refused by the port's
  ``init_params`` as the JAX package's ``init_params_and_axes`` fails on
  it.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.models import transformer as jax_tf
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.kernels import ops
from repro_torch.launch import train as port_train
from repro_torch.models import attention as attn
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
#: train_step's tolerance: loss relative, each gradient leaf against its
#: largest magnitude (tests/test_torch_moe.py's)
TRAIN_TOL = 1e-5
#: the smoke config as it is, and its dense variant
VARIANTS = {"smoke": {},
            "dense": dict(n_layers=2, first_dense_layers=0, moe=False)}


def _weights(**over):
    """(port cfg, JAX cfg, JAX params, port params) of the smoke config
    with ``over`` replaced."""
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **over)
    return cfg, jcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _batch(cfg, b=2, s=33, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _grads(cfg, params, toks):
    (tot, m), grads = port_step.value_and_grad(
        params, cfg, {"tokens": torch.from_numpy(toks).long()})
    return tot, m, grads


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax_under_each_remat(variant, remat):
    cfg, jcfg, jparams, params = _weights(remat=remat, **VARIANTS[variant])
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
    assert (float(m["moe_lb_loss"]) > 0) == cfg.moe
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= TRAIN_TOL * scale

    # the same gradients under every policy (the embedding's gradient
    # sums repeated tokens in a thread-dependent order on the CPU, so
    # leaves are held to 1e-6 of their largest, as in
    # tests/test_torch_remat.py)
    _, _, ref = _grads(dataclasses.replace(cfg, remat="none"), params, toks)
    for a, b in zip(tree.leaves(grads), tree.leaves(ref)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


def _sac_kept():
    """Shapes of the tensors the selective checkpoints hold for the
    backward (their storage's wrapped entries, found by the collector)."""
    from torch.utils.checkpoint import _VersionWrapper
    return sorted(tuple(o.val.shape) for o in gc.get_objects()
                  if type(o) is _VersionWrapper
                  and isinstance(o.val, torch.Tensor))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dots_keeps_the_mla_projections_and_the_ffn_products(variant):
    """Under ``dots`` each layer keeps its six MLA projections (x.Wq_a,
    c_q.Wq_b, x.Wkv_a, c.Wk_b, c.Wv_b, o.Wo: ``aten.mm``) and its FFN's
    products: the dense MLP's three, or the router's and the shared
    expert's three; never the routed experts' (``aten.bmm``)."""
    cfg, _, _, params = _weights(remat="dots", **VARIANTS[variant])
    toks = _batch(cfg)
    rows = toks.shape[0] * (toks.shape[1] - 1)
    leaves = port_step._trainable(params, tree.map(torch.zeros_like,
                                                   params))
    gc.collect()
    assert _sac_kept() == []
    with torch.enable_grad():
        total, _ = port_step.loss_fn(
            leaves, cfg, {"tokens": torch.from_numpy(toks).long()})
    h, e = cfg.n_heads, cfg.d_model
    mla = [(rows, cfg.q_lora_rank),
           (rows, h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)),
           (rows, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
           (rows, h * cfg.qk_nope_head_dim), (rows, h * cfg.v_head_dim),
           (rows, e)]
    want = []
    for i in range(cfg.n_layers):
        if cfg.ffn_kind(i) == "moe":
            fs = cfg.d_expert * cfg.n_shared_experts
            ffn = [(rows, cfg.n_experts), (rows, fs), (rows, fs), (rows, e)]
        else:
            ffn = [(rows, cfg.d_ff), (rows, cfg.d_ff), (rows, e)]
        want += mla + ffn
    assert _sac_kept() == sorted(want)
    total.backward()
    del total
    gc.collect()
    assert _sac_kept() == []


def test_cache_free_branch_hands_the_attention_a_contiguous_k(monkeypatch):
    """q and K reach ``ops.attention`` contiguous at D = nope + rope (the
    rope key broadcast over the heads by the concatenation), so
    ``fused_attention``'s ``.contiguous()`` copies neither; V (Dv = v)
    is the heads' view of one product."""
    cfg, _, _, params = _weights(**VARIANTS["dense"])
    lp = tree.map(lambda t: t[0], params["layers"][0]["attn"])
    seen = []
    orig = ops.attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    attn.mla_forward(lp, cfg, x, torch.arange(9))
    (q, k, v), = seen
    d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert q.shape == k.shape == (2, cfg.n_heads, 9, d)
    assert v.shape == (2, cfg.n_heads, 9, cfg.v_head_dim)
    assert q.is_contiguous() and k.is_contiguous()
    # every head's rope part is the one shared key
    rope = k[..., cfg.qk_nope_head_dim:]
    assert torch.equal(rope, rope[:, :1].expand_as(rope))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_loop_losses_match_jax(variant):
    cfg, jcfg, _, params = _weights(**VARIANTS[variant])
    kw = dict(steps=2, batch=2, seq=24, lr=1e-3, log_every=100)
    _, want = jax_train.train_loop(jcfg, **kw)
    _, got = port_train.train_loop(cfg, device="cpu", params=params, **kw)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_dense_prefix_only_depth_is_refused_as_jax_fails(n_layers):
    """``n_layers == first_dense_layers``: the JAX package stacks zero
    period trees and fails (repro/models/transformer.py init_model); the
    port's ``init_params`` refuses the config by name."""
    over = dict(n_layers=n_layers, first_dense_layers=n_layers)
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    with pytest.raises(TypeError):
        jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **over)
    with pytest.raises(ValueError, match="no layer follows the dense prefix"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # one layer past the prefix builds
    ok = dataclasses.replace(cfg, n_layers=n_layers + 1)
    assert len(init_params(ok, torch.Generator().manual_seed(0),
                           device="cpu")["prefix_layers"]) == n_layers
