"""The port's Mamba-2 slice against the JAX package, on the same numpy
inputs and weights: kernel #11's plain version against the Pallas
``ssd_scan`` in interpret mode and against ``chunked_ssd`` with an
initial state, the decode step, the mamba block, the whole mamba2 smoke
model's logits, the engine's token streams (and a preempt/resume), and
the slice's refusals.  fp32 throughout; the comparisons hold within
1e-4 (``rtol = atol = 1e-4``, the JAX package's own SSD tolerance):
both sides compute the same chunked formulas in fp32, summing in other
orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import xla_fallback as jxla
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.lower.runtime import serving_plan as jax_serving_plan
from repro.models import mamba as jmb
from repro.models import transformer as jax_tf
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestBatcher as JaxBatcher
from repro.serve.engine import \
    PagedContinuousBatchingEngine as JaxPagedEngine

from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_plain,
                                          ssd_step)
from repro_torch.launch import serve
from repro_torch.lower import serving_plan
from repro_torch.models import mamba as mb
from repro_torch.models import transformer as tf
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.batcher import Request, RequestBatcher
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      PagedContinuousBatchingEngine)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-130m"

#: the JAX package's SSD sweep (tests/test_kernels_ssd.py), then one L
#: off the chunk grid: B, L, H, P, G, S, chunk
SWEEP = [
    (1, 64, 1, 64, 1, 64, 32),
    (2, 256, 4, 64, 2, 128, 64),
    (1, 128, 8, 32, 4, 64, 128),
    (2, 96, 2, 64, 1, 32, 32),
    (2, 75, 4, 32, 2, 32, 32),
]


def _inputs(B, L, H, P, G, S, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, L, H, P)).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, H)))) * 0.1).astype(f)
    a = (-np.exp(rng.standard_normal(H))).astype(f)
    b = (rng.standard_normal((B, L, G, S)) * 0.3).astype(f)
    c = (rng.standard_normal((B, L, G, S)) * 0.3).astype(f)
    d = rng.standard_normal(H).astype(f)
    h0 = (rng.standard_normal((B, H, P, S)) * 0.5).astype(f)
    return x, dt, a, b, c, d, h0


def _t(*arrays):
    return [torch.from_numpy(np.array(v)) for v in arrays]


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SWEEP)
def test_plain_ssd_matches_pallas_interpret(B, L, H, P, G, S, chunk):
    """#11's plain version (and its wrapper and ``ops.ssd`` on a CPU
    tensor) against the TPU kernel run in interpret mode through the
    JAX ``ops.ssd`` (which pads an off-grid L): y and the final state."""
    x, dt, a, b, c, d, _ = _inputs(B, L, H, P, G, S)
    wy, wh = jops.ssd(*map(jnp.asarray, (x, dt, a, b, c, d)), chunk=chunk,
                      impl="pallas", interpret=True, return_final_state=True)
    args = _t(x, dt, a, b, c, d)
    for fn in (ssd_scan_plain, ssd_scan, ops.ssd):
        y, h = fn(*args, chunk=chunk, return_final_state=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_pallas_kernel_called_directly_agrees():
    """The TPU kernel itself (no ops padding), on the chunk grid."""
    x, dt, a, b, c, d, _ = _inputs(2, 128, 4, 64, 2, 32, seed=1)
    wy, wh = jax_ssd_scan(*map(jnp.asarray, (x, dt, a, b, c, d)), chunk=64,
                          interpret=True, return_final_state=True)
    y, h = ssd_scan_plain(*_t(x, dt, a, b, c, d), chunk=64,
                          return_final_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("L,chunk", [(96, 32), (75, 32), (130, 64)])
def test_plain_ssd_with_h0_matches_chunked_ssd_and_reference(L, chunk):
    x, dt, a, b, c, d, h0 = _inputs(2, L, 4, 32, 2, 32, seed=L)
    j = list(map(jnp.asarray, (x, dt, a, b, c, d)))
    wy, wh = jxla.chunked_ssd(*j, chunk=chunk, h0=jnp.asarray(h0),
                              return_final_state=True)
    ry, rh = jref.ssd_reference(*j, h0=jnp.asarray(h0),
                                return_final_state=True)
    args = _t(x, dt, a, b, c, d)
    y, h = ssd_scan_plain(*args, chunk=chunk, h0=torch.from_numpy(h0),
                          return_final_state=True)
    oy, oh = ref.ssd_reference(*args, h0=torch.from_numpy(h0),
                               return_final_state=True)
    ry_, rh_ = ops.ssd(*args, chunk=chunk, impl="reference",
                       h0=torch.from_numpy(h0), return_final_state=True)
    torch.testing.assert_close(ry_, oy, rtol=0, atol=0)
    for got_y, got_h in ((y, h), (oy, oh)):
        for want_y, want_h in ((wy, wh), (ry, rh)):
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                       **TOL)
            np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                       **TOL)


def test_one_scan_equals_two_half_scans():
    """The state carries: a scan over L equals one over the first part
    whose final state seeds one over the rest (cut off the chunk grid)."""
    x, dt, a, b, c, d, h0 = _inputs(1, 150, 2, 64, 1, 32, seed=5)
    x, dt, a, b, c, d, h0 = _t(x, dt, a, b, c, d, h0)
    y, h = ssd_scan_plain(x, dt, a, b, c, d, chunk=32, h0=h0,
                          return_final_state=True)
    cut = 71
    y1, h1 = ssd_scan_plain(x[:, :cut], dt[:, :cut], a, b[:, :cut],
                            c[:, :cut], d, chunk=32, h0=h0,
                            return_final_state=True)
    y2, h2 = ssd_scan_plain(x[:, cut:], dt[:, cut:], a, b[:, cut:],
                            c[:, cut:], d, chunk=32, h0=h1,
                            return_final_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **TOL)


def test_ssd_step_chain_matches_jax():
    x, dt, a, b, c, d, h0 = _inputs(3, 6, 4, 32, 2, 32, seed=9)
    jh = jnp.asarray(h0)
    h = torch.from_numpy(h0)
    for t in range(6):
        jy, jh = jxla.ssd_step(jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
                               jnp.asarray(a), jnp.asarray(b[:, t]),
                               jnp.asarray(c[:, t]), jnp.asarray(d), jh)
        y, h = ssd_step(*_t(x[:, t], dt[:, t], a, b[:, t], c[:, t], d), h)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    # the step is the scan of one position
    y1, h1 = ssd_scan_plain(*_t(x[:, :1], dt[:, :1], a, b[:, :1],
                                c[:, :1], d), chunk=8,
                            h0=torch.from_numpy(h0), return_final_state=True)
    ys, hs = ssd_step(*_t(x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], d),
                      torch.from_numpy(h0))
    np.testing.assert_allclose(ys.numpy(), y1[:, 0].numpy(), **TOL)
    np.testing.assert_allclose(hs.numpy(), h1.numpy(), **TOL)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_configs.get_config(ARCH, smoke=True)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config(ARCH, smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, jparams, params


def test_params_from_numpy_keeps_the_mamba_tree(model):
    cfg, _, jparams, params = model
    jl, jdef = jax.tree.flatten(jparams)
    assert jax.tree.structure(params) == jdef
    for a, b in zip(jl, jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lp = params["layers"][0]
    assert set(lp) == {"pre_norm", "mamba"}
    for k in ("a_log", "d_skip", "dt_bias"):
        assert lp["mamba"][k].dtype == torch.float32


def test_init_params_mamba_tree_matches_jax_shapes():
    from repro_torch.models.weights import init_params
    cfg = configs.get_config(ARCH, smoke=True)
    jcfg = jax_configs.get_config(ARCH, smoke=True)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(mine)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def _layer0(params):
    return {k: v[0] for k, v in params["layers"][0]["mamba"].items()}


@pytest.mark.parametrize("mode", ["cache_free", "prefill_chunks",
                                  "decode"])
def test_mamba_forward_matches_jax(model, mode):
    """One mamba block: cache-free; chunked prefill in chunks of 5, 2
    (shorter than W-1 = 3), 1 (the step path) and 9; then decode steps
    after a 6-token prefill.  Outputs and caches."""
    cfg, jcfg, jparams, params = model
    jp = jax.tree.map(lambda v: v[0], jparams["layers"][0]["mamba"])
    p = _layer0(params)
    rng = np.random.default_rng(11)
    b = 2
    if mode == "cache_free":
        x = rng.standard_normal((b, 37, cfg.d_model)).astype(np.float32)
        want, _ = jmb.mamba_forward(jp, jcfg, jnp.asarray(x))
        got, cache = mb.mamba_forward(p, cfg, torch.from_numpy(x))
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    sizes = [5, 2, 1, 9] if mode == "prefill_chunks" else [6, 1, 1, 1, 1]
    jcache = jmb.init_mamba_cache(jcfg, b, jnp.float32)
    cache = mb.init_mamba_cache(cfg, b, torch.float32, "cpu")
    for n in sizes:
        x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        want, jcache = jmb.mamba_forward(jp, jcfg, jnp.asarray(x),
                                         cache=jcache)
        got, cache = mb.mamba_forward(p, cfg, torch.from_numpy(x),
                                      cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
    assert cache["ssm"].dtype == torch.float32


def test_conv_tail_of_a_chunk_shorter_than_the_window():
    """The new conv cache is the last W-1 rows of [tail | xbc], which
    for a one-row chunk keeps two rows of the old tail."""
    w = torch.randn(4, 3)
    tail = torch.randn(1, 3, 3)
    xbc = torch.randn(1, 1, 3)
    _, new = mb._conv1d(xbc, w, torch.zeros(3), tail)
    torch.testing.assert_close(new, torch.cat([tail[:, 1:], xbc], 1),
                               rtol=0, atol=0)


def test_cache_free_model_logits_match_jax(model):
    cfg, jcfg, jparams, params = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 45))
    want = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got = tf.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_8_decode_steps_match_jax(model):
    cfg, jcfg, jparams, params = model
    b, s, max_len = 2, 70, 96
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    jcache = jax_tf.init_model_cache(jcfg, b, max_len, jnp.float32)
    cache = tf.init_model_cache(cfg, b, max_len, torch.float32, "cpu")
    assert set(cache["scan"][0]) == {"mamba"}
    jl, jcache = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                cache=jcache, cache_len=0)
    lg, cache = tf.forward(params, cfg, torch.from_numpy(toks), cache=cache,
                           cache_len=0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    lens = np.full((b,), s, np.int32)
    for step in range(8):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        jl, jcache = jax_tf.forward(
            jparams, jcfg, tokens=jnp.asarray(nxt)[:, None], cache=jcache,
            cache_len=jnp.asarray(lens))
        lg, cache = tf.forward(
            params, cfg, torch.from_numpy(nxt).long()[:, None], cache=cache,
            cache_len=torch.from_numpy(lens.copy()))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        lens += 1
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache["scan"][0]["mamba"][k].numpy(),
                                   np.asarray(jcache["scan"][0]["mamba"][k]),
                                   **TOL)


PROMPT_LENS = [44, 90, 49, 58]
MAX_LEN, CHUNK, BATCH, MAX_NEW = 160, 48, 3, 6


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(engine, batcher_cls, request_cls, prompts):
    b = batcher_cls(BATCH, max_len=MAX_LEN)
    for uid, p in enumerate(prompts):
        b.submit(request_cls(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    return {r.uid: r.generated for r in b.serve(engine, max_steps=200)}


def test_token_streams_match_jax_engine(model):
    """The dense engine, no plan (mamba is not lowerable), chunked
    prefill of 48 (the 49-token prompt ends in a one-token chunk, the
    step path), prompts longer than the batch: JAX's tokens."""
    cfg, jcfg, jparams, params = model
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine(jparams, jcfg, batch_size=BATCH,
                            max_len=MAX_LEN, prefill_chunk=CHUNK),
                  JaxBatcher, JaxRequest, prompts)
    ops.reset_counts()
    eng = ContinuousBatchingEngine(params, cfg, batch_size=BATCH,
                                   max_len=MAX_LEN, prefill_chunk=CHUNK,
                                   device="cpu")
    got = _serve(eng, RequestBatcher, Request, prompts)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    # one scan per layer and multi-token prefill chunk
    chunks = sum(sum(1 for st in range(0, n, CHUNK) if n - st > 1)
                 for n in PROMPT_LENS)
    assert ops.CALLS[("ssd", "torch")] == cfg.n_layers * chunks
    assert ops.CALLS[("ssd_step", "torch")] > 0


def _preempt_run(eng, prompts):
    """Prefill two requests, decode, preempt slot 0, decode, resume it
    into slot 2, decode: the tokens each request saw, in order."""
    toks = {0: [], 1: []}
    owner = {0: 0, 1: 1}
    eng.begin_prefill(0, prompts[0])
    eng.begin_prefill(1, prompts[1])

    def step():
        out, inserted = eng.step()
        for slot, first in inserted:
            toks[owner[slot]].append(int(first))
        if out is not None:
            for slot, uid in owner.items():
                if eng.live[slot]:
                    toks[uid].append(int(out[slot]))

    for _ in range(5):
        step()
    pre = eng.preempt(0)
    del owner[0]
    for _ in range(3):
        step()
    eng.resume(pre, 2)
    owner[2] = 0
    for _ in range(4):
        step()
    return toks


def test_dense_preempt_resume_of_a_mamba_row_matches_jax(model):
    cfg, jcfg, jparams, params = model
    prompts = _prompts(cfg.vocab_size)[:2]
    want = _preempt_run(JaxEngine(jparams, jcfg, batch_size=BATCH,
                                  max_len=MAX_LEN, prefill_chunk=CHUNK),
                        prompts)
    got = _preempt_run(ContinuousBatchingEngine(
        params, cfg, batch_size=BATCH, max_len=MAX_LEN, prefill_chunk=CHUNK,
        device="cpu"), prompts)
    assert got == want
    # uid 0: inserted and decoded at step 1, 5 steps, paused 3, 4 more;
    # uid 1 (two prefill chunks): inserted at step 2, then every step
    assert len(got[0]) == 1 + 4 + 1 + 4 and len(got[1]) == 1 + 3 + 3 + 4 + 1


def test_no_serving_plan_and_the_paged_engine_refuses():
    cfg = configs.get_config(ARCH)
    jcfg = jax_configs.get_config(ARCH)
    assert serving_plan(cfg, 1024, device="cpu") is None
    assert jax_serving_plan(jcfg, 1024) is None
    smoke, jsmoke = configs.get_config(ARCH, smoke=True), \
        jax_configs.get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError) as want:
        JaxPagedEngine(None, jsmoke, batch_size=2, max_len=64,
                       page_size=16, num_pages=8)
    with pytest.raises(NotImplementedError) as got:
        PagedContinuousBatchingEngine(None, smoke, batch_size=2, max_len=64,
                                      page_size=16, num_pages=8,
                                      device="cpu")
    assert str(got.value) == str(want.value)
    assert "layer 0 is 'mamba'" in str(got.value)


def test_ssd_refuses_a_tensor_that_requires_grad():
    """#11 has no backward (nor has the TPU kernel): ``ssd_scan`` and
    ``ops.ssd(impl="cuda")`` refuse a tracked input.  ``ops.ssd`` with
    ``auto`` or ``torch`` differentiates through the plain scan, as the
    JAX package trains through its lax scan."""
    x, dt, a, b, c, d = _t(*_inputs(1, 8, 2, 8, 1, 8)[:6])
    x.requires_grad_()
    for fn, kw in ((ssd_scan, {}), (ops.ssd, {"impl": "cuda"})):
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(x, dt, a, b, c, d, chunk=8, **kw)
    with torch.no_grad():
        assert ssd_scan(x, dt, a, b, c, d, chunk=8).shape == x.shape
    want = torch.autograd.grad(
        ssd_scan_plain(x, dt, a, b, c, d, chunk=8).sum(), x)[0]
    for impl in ("auto", "torch"):
        y = ops.ssd(x, dt, a, b, c, d, chunk=8, impl=impl)
        assert y.requires_grad
        torch.testing.assert_close(torch.autograd.grad(y.sum(), x)[0],
                                   want, rtol=0, atol=0)


def test_transformer_refuses_the_hybrid_and_admits_moe():
    """The attention/Mamba-2 hybrid (jamba's ``attn_every``) is admitted
    since the hybrid slice, as are MoE stacks; a stack whose attention
    layers have no flavour the port runs is refused."""
    import dataclasses
    jamba = jax_configs.get_config("jamba-1.5-large-398b", smoke=True)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True),
                              attn_every=jamba.attn_every, n_heads=4)
    tf.check_ported(cfg)
    tf.check_ported(configs.get_config("jamba-1.5-large-398b"))
    with pytest.raises(NotImplementedError, match="GQA or MLA"):
        tf.check_ported(dataclasses.replace(cfg, attention="none"))
    tf.check_ported(dataclasses.replace(
        configs.get_config("qwen3-8b", smoke=True), moe=True, n_experts=4))
    tf.check_ported(configs.get_config(ARCH))
    tf.check_ported(configs.get_config("qwen3-8b"))


def test_serve_main_runs_mamba_without_a_plan(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "decode kernel paths" not in out
