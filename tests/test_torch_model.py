"""The port's model against the JAX package's, on the same weights.

``params_from_numpy`` carries the JAX tree from
``init_params_and_axes(PRNGKey(0), cfg)`` over leaf for leaf; then the
smoke configs' logits through a cached prefill plus 8 per-row decode
steps must match ``repro.models.transformer.forward`` in fp32 (atol
1e-4: the two sum in different orders over 2 layers), with and without
the serving plan's kernel paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf

from repro_torch import configs, lower
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import init_params, params_from_numpy

torch.set_num_threads(2)

ATOL = 1e-4
ARCHS = configs.list_archs("dense")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_configs.get_config(arch, smoke=True)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg, device="cpu")


def test_params_from_numpy_keeps_the_tree(model):
    cfg, _, jparams, params = model
    jl, jdef = jax.tree.flatten(jparams)
    pl, _ = jax.tree.flatten(params)
    assert jax.tree.structure(params) == jdef
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert params["layers"][0]["attn"]["wq"].shape == \
        (cfg.n_periods, cfg.d_model, cfg.n_heads, cfg.head_dim)


def test_cache_free_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    want = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got = tf.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("planned", [False, True])
def test_prefill_and_8_decode_steps_match_jax(model, planned):
    """A 70-token prompt (past 2N = 64 for the smoke head width) so the
    planned run climbs to the fused paths; per-row decode steps."""
    cfg, jcfg, jparams, params = model
    b, s, max_len = 2, 70, 96
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    jcache = jax_tf.init_model_cache(jcfg, b, max_len, jnp.float32)
    cache = tf.init_model_cache(cfg, b, max_len, torch.float32, "cpu")
    plan = lower.serving_plan(cfg, max_len, device="cpu") if planned \
        else None

    jl, jcache = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                cache=jcache, cache_len=0)
    d = plan.prefill_dispatch(s) if planned else None
    lg, cache = tf.forward(params, cfg, torch.from_numpy(toks),
                           cache=cache, cache_len=0, plan=d)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    lens = np.full((b,), s, np.int32)
    for step in range(8):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        jl, jcache = jax_tf.forward(
            jparams, jcfg, tokens=jnp.asarray(nxt)[:, None], cache=jcache,
            cache_len=jnp.asarray(lens))
        d = plan.decode_dispatch(int(lens.max()) + 1) if planned else None
        lg, cache = tf.forward(
            params, cfg, torch.from_numpy(nxt).long()[:, None], cache=cache,
            cache_len=torch.from_numpy(lens.copy()), plan=d)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        lens += 1
    if planned:
        paths = {r[3] for r in plan.resolutions}
        assert lower.FUSED_ATTENTION in paths
        if not cfg.qk_norm:
            assert lower.DECODE_MEGAKERNEL in paths


def test_init_params_shapes_and_seed():
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    assert a["layers"][0]["mlp"]["w_up"].shape == \
        (cfg.n_periods, cfg.d_model, cfg.d_ff)
    assert "w_gate" not in a["layers"][0]["mlp"]     # gelu MLP
    w = a["layers"][0]["attn"]["wq"]
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


def test_torch_dtype():
    cfg = configs.get_config("qwen3-8b")
    assert isinstance(cfg, ModelConfig)
    assert cfg.torch_dtype() == torch.bfloat16
    assert configs.get_config("qwen3-8b", smoke=True).torch_dtype(
        "param") == torch.float32
