"""jamba-1.5's attention/Mamba-2 hybrid (smoke config: 8 layers of period
8, attention at offset 3, MoE every other layer) in the port against
the JAX package, on the same weights (``params_from_numpy`` of
``init_params_and_axes(PRNGKey(0))``) and numpy inputs, fp32 on the
CPU:

* the config, its family (``"hybrid"``, so ``list_archs("moe")`` keeps
  phi3.5-moe alone) and ``init_params``' tree against JAX's
  ``init_model``: every Mamba layer of the hybrid carries its FFN;
* the cache-free logits, and a chunked prefill with decode steps over
  the mixed cache (K/V at the attention layer, the conv tail and fp32
  SSM state at the Mamba layers): within 1e-4, the JAX suite's model
  tolerance (MoE routes in fp32);
* the attention layer's plan-less dispatch at full width, keyed like
  JAX's on the K buffer's length (the cache's ``max_len``);
* ``train_step``'s loss and every gradient leaf under none, full and
  dots against ``jax.value_and_grad`` of JAX's ``loss_fn``: within
  ``HYBRID_TRAIN_TOL`` of each leaf's largest;
* the refusals: the paged engine (JAX's message) and ``rollback_slot``.

``tests/test_torch_hybrid_serve.py`` holds the engines' token streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as jax_configs
from repro.kernels import ops as jops
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.kernels import ops
from repro_torch.lower.runtime import shape_dispatch
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine,
                               PagedContinuousBatchingEngine)
from repro_torch.serve import engine
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-4
#: gradients against JAX's, relative to each leaf's largest magnitude:
#: eight fp32 layers, seven of them SSD scans summed in another order,
#: put the worst leaf near 2e-5 (a MoE expert's w_gate at seq 33)
HYBRID_TRAIN_TOL = 5e-5
CHUNK, MAX_LEN, BATCH = 16, 160, 3

_W: dict = {}


def _weights():
    if not _W:
        jcfg = jax_configs.get_config(ARCH, smoke=True)
        jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_config(ARCH, smoke=True)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _W["w"] = (cfg, jcfg, jparams, params)
    return _W["w"]


@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax_and_registers(smoke):
    cfg = configs.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_configs.get_config(ARCH, smoke=smoke))
    assert configs.family(ARCH) == "hybrid"
    assert configs.list_archs("hybrid") == [ARCH]
    assert configs.list_archs("moe") == ["phi3.5-moe-42b-a6.6b"]
    assert ARCH not in configs.list_archs("dense")
    assert configs.list_archs() == [a for a in configs.ARCHS]
    assert set(configs.list_archs()) == set(jax_configs.list_archs())
    kinds = [(cfg.block_kind(i), cfg.ffn_kind(i)) for i in range(8)]
    assert [k for k, _ in kinds] == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    tf.check_ported(cfg)


def _skeleton(t):
    """(shape, dtype name) of every leaf, in the tree's structure."""
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)


@pytest.mark.parametrize("over", [{}, {"moe": False},
                                  {"n_layers": 16, "attn_offset": 0}])
def test_init_params_tree_matches_jax(over):
    """``init_params`` and ``params_from_numpy`` give JAX's ``init_model``
    tree, shapes and dtypes: each Mamba layer of the hybrid has
    ``ffn_norm`` and an ``mlp`` or ``moe`` (the MoE router fp32).  A
    pure Mamba-2 stack keeps none."""
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    want = _skeleton(jax.tree.map(np.asarray, jparams))
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    numpy_of = lambda p: jax.tree.map(
        lambda t: np.zeros(t.shape, str(t.dtype).split(".")[-1]), p)
    assert _skeleton(numpy_of(mine)) == want
    bridged = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    assert _skeleton(numpy_of(bridged)) == want
    assert all("ffn_norm" in lp for lp in mine["layers"])
    pure = configs.get_config("mamba2-130m", smoke=True)
    lp = init_params(pure, torch.Generator().manual_seed(0),
                     "cpu")["layers"][0]
    assert set(lp) == {"pre_norm", "mamba"}


def test_model_logits_match_jax():
    cfg, jcfg, jparams, params = _weights()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    want = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got = tf.forward(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_chunked_prefill_and_decode_logits_match_jax():
    """A 45-token prompt in chunks of 16 (a ragged last one) over the
    mixed cache, then 4 per-row decode steps: each chunk's and step's
    logits within 1e-4, the same tokens, and every cache leaf."""
    cfg, jcfg, jparams, params = _weights()
    b, s = 2, 45
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    jstate = jax_engine.init_decode_state(jcfg, b, MAX_LEN, jnp.float32)
    state = engine.init_decode_state(cfg, b, MAX_LEN, torch.float32,
                                     device="cpu")
    assert sorted(state.cache["scan"][3]) == ["attn"]
    assert sorted(state.cache["scan"][0]) == ["mamba"]
    assert state.cache["scan"][0]["mamba"]["ssm"].dtype == torch.float32
    jcache, cache = jstate.cache, state.cache
    for start in range(0, s, CHUNK):
        piece = toks[:, start:start + CHUNK]
        jl, jcache = jax_tf.forward(jparams, jcfg,
                                    tokens=jnp.asarray(piece),
                                    cache=jcache, cache_len=start)
        lg, cache = tf.forward(params, cfg, torch.from_numpy(piece).long(),
                               cache=cache, cache_len=start)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {start}")
    jstate = jax_engine.DecodeState(
        cache=jcache, cache_len=jnp.full((b,), s, jnp.int32),
        last_token=jax_engine.greedy_sample(jl))
    state = engine.DecodeState(
        cache=cache, cache_len=torch.full((b,), s, dtype=torch.int32),
        last_token=engine.greedy_sample(lg))
    for step in range(4):
        jstate, jl = jax_engine.decode_step(jparams, jcfg, jstate)
        state, lg = engine.decode_step(params, cfg, state)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        assert state.last_token.tolist() == \
            np.asarray(jstate.last_token).tolist()
    for got, want in zip(tree.leaves(state.cache),
                         jax.tree.leaves(jstate.cache)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("rows,path", [(1, "fused_attention"),
                                       (256, "fused_attention"),
                                       (44, "unfused")])
def test_full_width_attention_dispatch_matches_jax(rows, path):
    """jamba's attention layer at full width (64 query heads over 8 of
    128) served at max_len 1024, as on the card: the port's shape-only
    plan at the K buffer's 1024 rows takes JAX's path, whatever the
    context: decode steps and 256-row prefill chunks fuse (#1), and a
    44-row last chunk (a 300-token prompt's) runs the reference."""
    cfg = configs.get_config(ARCH)
    got = shape_dispatch(seq_q=rows, seq_kv=1024, d_head=cfg.head_dim,
                         n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads,
                         device="cpu", lengths_masked=True)
    want = jops._auto_dispatch("attention", rows, 1024, cfg.head_dim,
                               cfg.n_heads, cfg.kv_heads, True,
                               interpret=True)
    assert got.path == want.path == path


def test_rollback_slot_refuses_the_hybrids_mamba_layers():
    """The Mamba layers' conv tail and SSM state cannot be rewound (a
    decode step overwrites them in place), so ``rollback_slot`` refuses,
    naming them; the attention layer 3 is not among them."""
    cfg, _, _, params = _weights()
    eng = ContinuousBatchingEngine(params, cfg, batch_size=BATCH,
                                   max_len=MAX_LEN, prefill_chunk=CHUNK,
                                   device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"layers \[0, 1, 2, 4, 5, 6, 7\]"):
        eng.rollback_slot(0, 0, 0)


def test_paged_engine_refuses_the_hybrid_like_jax():
    cfg, jcfg, jparams, params = _weights()
    with pytest.raises(NotImplementedError) as want:
        J.PagedContinuousBatchingEngine(jparams, jcfg, batch_size=2,
                                        max_len=64, page_size=8,
                                        num_pages=16)
    with pytest.raises(NotImplementedError) as got:
        PagedContinuousBatchingEngine(params, cfg, batch_size=2, max_len=64,
                                      page_size=8, num_pages=16,
                                      device="cpu")
    assert str(got.value) == str(want.value)
    assert "layer 0 is 'mamba'" in str(got.value)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_matches_jax_under_each_remat(remat):
    """The loss, the MoE aux losses and every gradient leaf against
    JAX's, the Mamba layers through the plain scan (``ops.ssd`` under
    autograd), the attention layer through #7-#9's plain versions."""
    cfg, jcfg, jparams, params = _weights()
    cfg, jcfg = (dataclasses.replace(c, remat=remat) for c in (cfg, jcfg))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    (jtot, jm), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    ops.reset_counts()
    (tot, m), grads = port_step.value_and_grad(
        params, cfg, {"tokens": torch.from_numpy(toks).long()})
    runs = 1 if remat == "none" else 2          # the recompute
    assert ops.CALLS[("ssd", "torch")] == 7 * runs
    assert sum(n for (e, _), n in ops.CALLS.items()
               if e == "attention") == runs
    assert float(tot) == pytest.approx(float(jtot), rel=1e-5)
    for key in ("loss", "moe_lb_loss", "moe_z_loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= HYBRID_TRAIN_TOL * scale
