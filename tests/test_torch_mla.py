"""Multi-head Latent Attention (deepseek-v3) of the port against the JAX
package's, on the CPU, fp32, with weights shared through
``params_from_numpy`` and inputs made with numpy from a seed:

* the config and its registration; ``init_params``' MLA leaves against
  ``init_params_and_axes``' tree and shapes (the norms at ones);
* ``mla_forward`` without a cache (per-head K/V, D = nope + rope) and in
  the absorbed form over the latent cache (a scalar ``cache_len``
  prefill, a second chunk, then per-row decode steps), outputs and
  caches within 1e-5;
* the absorbed decode against the cache-free forward of the same
  tokens (the JAX suite's decode-consistency property);
* #1's plain version at the latent widths (D 576, Dv 512, 8 query heads
  over 1, V the first 512 columns of K, scale 192^-0.5) against the
  Pallas kernel in interpret mode, at Sq 1 and Sq 5, within 1e-5;
* the shape-only plans of the absorbed call (128 heads of 576 over 1)
  against JAX's at the crossovers (decode C 1152/1153, prefill M
  512/513/576/577), through ``kernels.ops``' auto dispatch too;
* ``serving_plan`` None for MLA, as in the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import lower as jax_lower
from repro.kernels import ops as jops
from repro.kernels.fused_attention import (
    fused_attention_masked as pallas_attention_masked)
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf

from repro_torch import configs, lower
from repro_torch.kernels import ops
from repro_torch.kernels.fused_attention import fused_attention_masked
from repro_torch.models import attention as attn
from repro_torch.models.weights import init_params, params_from_numpy

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
ATOL = 1e-5         # fp32: the two sum in different orders, nothing rounds

_W: dict = {}


def _weights():
    """(port cfg, JAX cfg, JAX params, port params) of the smoke config."""
    if not _W:
        jcfg = jax_configs.get_config(ARCH, smoke=True)
        jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_config(ARCH, smoke=True)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _W["w"] = (cfg, jcfg, jparams, params)
    return _W["w"]


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=msg)


def test_config_matches_jax_and_registers():
    for smoke in (False, True):
        assert dataclasses.asdict(configs.get_config(ARCH, smoke)) == \
            dataclasses.asdict(jax_configs.get_config(ARCH, smoke))
    assert configs.family(ARCH) == "mla"
    assert configs.list_archs("mla") == [ARCH]
    assert ARCH not in configs.list_archs("moe")
    cut = dataclasses.replace(configs.get_config(ARCH), n_layers=4)
    assert [cut.ffn_kind(i) for i in range(4)] == ["dense"] * 3 + ["moe"]


def test_init_params_gives_the_jax_tree():
    """``init_params``' tree, shapes and dtypes are JAX's leaf for leaf;
    the MLA norms start at ones."""
    cfg, jcfg, jparams, _ = _weights()
    g = torch.Generator()
    g.manual_seed(0)
    params = init_params(cfg, g, "cpu")
    jflat, jdef = jax.tree_util.tree_flatten_with_path(jparams)
    flat = {jax.tree_util.keystr(p): np.asarray(x).shape for p, x in jflat}
    ours, odef = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    assert {jax.tree_util.keystr(p): x.shape for p, x in ours} == flat
    assert jdef == odef
    for lp in (params["prefix_layers"][0], params["layers"][0]):
        a = lp["attn"]
        assert sorted(a) == sorted(jparams["prefix_layers"][0]["attn"])
        assert torch.equal(a["q_a_norm"], torch.ones_like(a["q_a_norm"]))
        assert torch.equal(a["kv_a_norm"], torch.ones_like(a["kv_a_norm"]))
    a = params["prefix_layers"][0]["attn"]
    assert tuple(a["wq_b"].shape) == (64, 4, 48)
    assert tuple(a["wkv_a"].shape) == (128, 48 + 16)
    assert tuple(a["wo"].shape) == (4, 32, 128)


def _layer(params, jparams):
    return (params["prefix_layers"][0]["attn"],
            jparams["prefix_layers"][0]["attn"])


def _x(b, s, e, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, e)).astype(np.float32)


def test_cache_free_forward_matches_jax():
    cfg, jcfg, jparams, params = _weights()
    lp, jlp = _layer(params, jparams)
    x = _x(2, 24, cfg.d_model, 0)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    want, _ = jax_attn.mla_forward(jlp, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos))
    got, cache = attn.mla_forward(lp, cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()),
                                  impl="torch")
    assert cache is None
    _close(got, want)


def test_absorbed_prefill_and_decode_match_jax():
    """A scalar-``cache_len`` prefill of 20 tokens, a second chunk of 7,
    then per-row decode steps at rows 27 and 13 (row 1 rewound): each
    output and the latent cache within 1e-5."""
    cfg, jcfg, jparams, params = _weights()
    lp, jlp = _layer(params, jparams)
    b, max_len, e = 2, 48, cfg.d_model
    cache = attn.init_cache(cfg, b, max_len, torch.float32, "cpu")
    jcache = jax_attn.init_cache(jcfg, b, max_len, jnp.float32)
    assert tuple(cache["latent"].shape) == (b, max_len, 48 + 16)
    x = _x(b, 27, e, 1)
    for start, stop in ((0, 20), (20, 27)):
        pos = np.broadcast_to(np.arange(start, stop, dtype=np.int32),
                              (b, stop - start))
        want, jcache = jax_attn.mla_forward(
            jlp, jcfg, jnp.asarray(x[:, start:stop]), jnp.asarray(pos),
            cache=jcache, cache_len=start)
        got, cache = attn.mla_forward(
            lp, cfg, torch.from_numpy(x[:, start:stop].copy()),
            torch.from_numpy(pos.copy()), cache=cache, cache_len=start,
            impl="torch")
        _close(got, want, msg=f"chunk at {start}")
    _close(cache["latent"], jcache["latent"])
    lens = np.array([27, 13], np.int32)
    for step in range(3):
        xt = _x(b, 1, e, 10 + step)
        want, jcache = jax_attn.mla_forward(
            jlp, jcfg, jnp.asarray(xt), jnp.asarray(lens[:, None]),
            cache=jcache, cache_len=jnp.asarray(lens))
        got, cache = attn.mla_forward(
            lp, cfg, torch.from_numpy(xt), torch.from_numpy(lens[:, None]),
            cache=cache, cache_len=torch.from_numpy(lens.copy()),
            impl="torch")
        _close(got, want, msg=f"decode step {step}")
        lens = lens + 1
    _close(cache["latent"], jcache["latent"])


def test_absorbed_decode_matches_the_cache_free_forward():
    """The last 3 of 16 tokens decoded one by one over the latent cache
    give the cache-free forward's outputs at those positions (the JAX
    suite's ``test_smoke_decode_consistency`` property), on the port."""
    cfg, _, _, params = _weights()
    lp = params["layers"][0]["attn"]
    lp = {k: v[0] for k, v in lp.items()}
    x = torch.from_numpy(_x(2, 16, cfg.d_model, 3))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    full, _ = attn.mla_forward(lp, cfg, x, pos, impl="torch")
    cache = attn.init_cache(cfg, 2, 32, torch.float32, "cpu")
    _, cache = attn.mla_forward(lp, cfg, x[:, :13], pos[:, :13], cache=cache,
                                cache_len=0, impl="torch")
    for t in range(13, 16):
        lens = torch.full((2,), t, dtype=torch.int32)
        out, cache = attn.mla_forward(lp, cfg, x[:, t:t + 1], lens[:, None],
                                      cache=cache, cache_len=lens,
                                      impl="torch")
        _close(out[:, 0], full[:, t].numpy(), msg=f"position {t}")


# b, hq, sq, skv, lengths: 8 query heads over the one latent head
LATENT_CASES = [(2, 8, 1, 160, [100, 37]), (2, 8, 5, 192, [70, 192]),
                (1, 8, 3, 96, [3])]


@pytest.mark.parametrize("b,hq,sq,skv,lengths", LATENT_CASES)
def test_plain_masked_at_latent_widths_matches_pallas(b, hq, sq, skv,
                                                      lengths):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, hq, sq, 576)).astype(np.float32)
    kv = rng.standard_normal((b, 1, skv, 576)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    scale = 192 ** -0.5
    want = pallas_attention_masked(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv[..., :512]),
        jnp.asarray(lens), causal=True, scale=scale, block_q=128,
        block_k=64, interpret=True)
    k = torch.from_numpy(kv)
    got = fused_attention_masked(torch.from_numpy(q), k, k[..., :512],
                                 torch.from_numpy(lens), causal=True,
                                 scale=scale)
    assert got.shape == (b, hq, sq, 512)
    _close(got, want)


# (Sq, Skv, path) at 128 heads of 576 over 1: decode fuses past C = 2N =
# 1152; prefill buckets M to the next power of two, so 513..1024 rows
# (576 and 577 among them) take the kernel and 512 the reference
LATENT_PLANS = [(1, 1152, "unfused"), (1, 1153, "decode_megakernel"),
                (512, 2048, "unfused"), (513, 2048, "fused_attention"),
                (576, 2048, "fused_attention"),
                (577, 2048, "fused_attention"),
                (1024, 2048, "fused_attention"), (276, 2048, "unfused")]


@pytest.mark.parametrize("sq,skv,path", LATENT_PLANS)
def test_latent_head_plans_match_jax(sq, skv, path):
    kw = dict(seq_q=sq, seq_kv=skv, d_head=576, n_heads=128, n_kv_heads=1)
    ours, theirs = lower.kernel_plan(**kw), jax_lower.kernel_plan(**kw)
    assert (ours.kernel_path, ours.phase, ours.bucket, ours.M,
            ours.score_cols) == (theirs.kernel_path, theirs.phase,
                                 theirs.bucket, theirs.M, theirs.score_cols)
    assert ours.kernel_path == path
    got = ops._auto_dispatch("attention", sq, skv, 576, 128, 1, True,
                             torch.device("cpu"))
    want = jops._auto_dispatch("attention", sq, skv, 576, 128, 1, True,
                               False)
    assert (got.path, got.impl == "reference") == \
        (want.path, want.impl == "reference")
    assert got.impl == ("reference" if path == "unfused" else "torch")


def test_no_serving_plan_for_mla():
    cfg, jcfg, _, _ = _weights()
    assert lower.serving_plan(cfg, 256, device="cpu") is None
    assert jax_lower.serving_plan(jcfg, 256) is None
    assert not lower.supported(cfg) and not jax_lower.supported(jcfg)


def test_wide_body_chunk_rule_and_the_latent_view():
    """The wide body's split (``wide_chunks``, mirrored by the .cu
    file's chunk plan): at decode (B = 4, 128 heads over 1) its 8 bf16
    row tiles of 64 (32 fp32 tiles of 16) leave 132 SMs idle, so 16 (4)
    chunks of whole 32-key tiles; a 1024-row prefill chunk runs in one
    pass.  The absorbed call's V is a column prefix of the latent K,
    which the wrapper accepts as a view and nothing else."""
    from repro_torch.kernels.fused_attention import (
        WIDE_TILE, chunk_bounds, is_column_prefix, wide_chunks)
    assert wide_chunks(4, 128, 1, 1, 132, torch.bfloat16) == 16
    assert wide_chunks(4, 128, 1, 1, 132, torch.float32) == 4
    assert wide_chunks(1, 128, 1, 1024, 132, torch.bfloat16) == 1
    assert wide_chunks(1, 128, 1, 1024, 132, torch.float32) == 1
    assert chunk_bounds(2048, 16, WIDE_TILE) == [
        (s, s + 128) for s in range(0, 2048, 128)]
    # 37 tiles in chunks of 3: 13 chunks, the last one key long
    assert len(chunk_bounds(1153, 16, WIDE_TILE)) == 13
    assert chunk_bounds(1153, 16, WIDE_TILE)[-1] == (1152, 1153)
    cfg = configs.get_config(ARCH)
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    cache = attn.init_cache(cfg, 2, 16, torch.bfloat16, "cpu")
    k = cache["latent"][:, None]
    assert width == 576 and tuple(k.shape) == (2, 1, 16, 576)
    assert is_column_prefix(k, k[..., :cfg.kv_lora_rank])
    assert not is_column_prefix(k, k[..., :512].contiguous())
    assert not is_column_prefix(k, k[..., 64:])
    assert attn.mla_scale(cfg) == 192 ** -0.5
