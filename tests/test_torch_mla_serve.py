"""deepseek-v3's smoke config (MLA, a dense-FFN layer, then MoE layers)
served by the port against the JAX package, on the same weights, in
fp32 on the CPU.  Neither package has a serving plan for MLA; the
port's engine resolves each chunk and step on the shape-only plan of
the absorbed call (4 heads of 64 over the latent head at the smoke
widths, so decode fuses past C = 2N = 128):

* the cache-free model's logits, and a chunked prefill with decode
  steps over the latent cache: within 1e-4 (MoE routes in fp32; the
  JAX suite's model tolerance);
* the dense engine's token stream (a prompt that crosses C = 128
  mid-decode, both decode paths taken) and ``launch.serve.run``'s:
  JAX's tokens;
* the latent leaf through the engine's insert, side cache, preempt and
  resume (JAX's tokens), a crash restored from a snapshot (the JAX
  supervisor's uncrashed tokens) and ``rollback_slot``;
* the paged engine's refusal, with the JAX package's error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as tf
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine,
                               PagedContinuousBatchingEngine, Request,
                               RequestBatcher, ServingSupervisor,
                               audit_engine)
from repro_torch.serve import engine

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
ATOL = 1e-4
CHUNK, MAX_LEN, BATCH, MAX_NEW = 16, 160, 3, 6
#: the smoke's latent heads: D = 48 + 16 = 64, so the decode crossover
#: sits at C = 2N = 128; the 124-token prompt's steps cross it
PROMPT_LENS = (44, 124, 71, 58)

_W: dict = {}


@pytest.fixture(autouse=True)
def _no_injector_left():
    ops.set_fault_injector(None)
    yield
    ops.set_fault_injector(None)


def _weights():
    if not _W:
        jcfg = jax_configs.get_config(ARCH, smoke=True)
        jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_config(ARCH, smoke=True)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _W["w"] = (cfg, jcfg, jparams, params)
    return _W["w"]


def _prompts(vocab, lens=PROMPT_LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def test_model_logits_match_jax():
    cfg, jcfg, jparams, params = _weights()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    want = jax_tf.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    got = tf.forward(params, cfg, torch.from_numpy(toks).long(),
                     impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_chunked_prefill_and_decode_logits_match_jax():
    """A 40-token prompt in chunks of 16 over the latent cache, then 4
    per-row decode steps: each chunk's and step's logits within 1e-4,
    the same tokens."""
    cfg, jcfg, jparams, params = _weights()
    b = 2
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, 40)).astype(np.int32)
    jstate = jax_engine.init_decode_state(jcfg, b, MAX_LEN, jnp.float32)
    state = engine.init_decode_state(cfg, b, MAX_LEN, torch.float32,
                                     device="cpu")
    jcache, cache = jstate.cache, state.cache
    for start in range(0, 40, CHUNK):
        piece = toks[:, start:start + CHUNK]
        jl, jcache = jax_tf.forward(jparams, jcfg,
                                    tokens=jnp.asarray(piece),
                                    cache=jcache, cache_len=start)
        lg, cache = tf.forward(params, cfg, torch.from_numpy(piece).long(),
                               cache=cache, cache_len=start)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {start}")
    jstate = jax_engine.DecodeState(
        cache=jcache, cache_len=jnp.full((b,), 40, jnp.int32),
        last_token=jax_engine.greedy_sample(jl))
    state = engine.DecodeState(
        cache=cache, cache_len=torch.full((b,), 40, dtype=torch.int32),
        last_token=engine.greedy_sample(lg))
    for step in range(4):
        jstate, jl = jax_engine.decode_step(jparams, jcfg, jstate)
        state, lg = engine.decode_step(params, cfg, state)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        assert state.last_token.tolist() == \
            np.asarray(jstate.last_token).tolist()


def _serve(eng, batcher_cls, request_cls, prompts, max_new=MAX_NEW):
    b = batcher_cls(BATCH, max_len=MAX_LEN)
    for uid, p in enumerate(prompts):
        b.submit(request_cls(uid=uid, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.generated for r in b.serve(eng, max_steps=300)}


def _jax_engine(jcfg, jparams):
    assert J.make_serving_plan(jcfg, MAX_LEN) is None
    return J.ContinuousBatchingEngine(jparams, jcfg, batch_size=BATCH,
                                      max_len=MAX_LEN, prefill_chunk=CHUNK)


def _engine(cfg, params):
    assert engine.make_serving_plan(cfg, MAX_LEN, device="cpu") is None
    return ContinuousBatchingEngine(params, cfg, batch_size=BATCH,
                                    max_len=MAX_LEN, prefill_chunk=CHUNK,
                                    device="cpu")


def test_dense_token_stream_matches_jax_engine():
    """The dense engine's tokens are JAX's; the 124-token prompt's steps
    resolve at C <= 128 on the reference, then past it on #1's plain
    version, mid-request; chunks of 16 rows stay below N = 64."""
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size)
    want = _serve(_jax_engine(jcfg, jparams), J.RequestBatcher, J.Request,
                  prompts)
    eng = _engine(cfg, params)
    steps = []
    decode_once = eng.decode_once

    def recorded():
        ctx = max((c for c, a in zip(eng.row_ctx, eng.live) if a),
                  default=0)
        out = decode_once()
        if out is not None:
            steps.append((ctx + 1, eng.last_dispatch.path,
                          eng.last_dispatch.impl))
        return out

    eng.decode_once = recorded
    ops.reset_counts()
    got = _serve(eng, RequestBatcher, Request, prompts)
    assert got == want and len(got) == 4
    assert all(len(t) == MAX_NEW for t in got.values())
    for c, path, impl in steps:
        assert (path, impl) == (("unfused", "reference") if c <= 128
                                else ("fused_attention", "torch")), c
    assert {s[2] for s in steps} == {"reference", "torch"}
    assert ops.CALLS[("attention", "torch")] > 0
    assert ops.CALLS[("attention", "reference")] > 0


def test_launch_serve_run_matches_jax_engine():
    cfg, jcfg, jparams, params = _weights()
    args = port_serve.parser().parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
        str(BATCH), "--max-len", str(MAX_LEN), "--prefill-chunk",
        str(CHUNK), "--max-new", str(MAX_NEW)])
    requests = port_serve.make_requests(cfg, 3, MAX_NEW,
                                        prompt_lens=(20, 50), seed=3)
    prompts = [r.prompt for r in requests]
    out = port_serve.run(args, cfg, params, requests)
    assert out["plan"] is None
    got = {r.uid: r.generated for r in out["finished"]}
    want = _serve(_jax_engine(jcfg, jparams), J.RequestBatcher, J.Request,
                  prompts)
    assert got == want


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
    assert sorted(pre.kv["prefix"][0]["attn"]) == ["latent"]
    del owner[0]
    for _ in range(3):
        step()
    eng.resume(pre, 2)
    owner[2] = 0
    for _ in range(4):
        step()
    return toks


def test_dense_preempt_resume_of_a_latent_row_matches_jax():
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size, (20, 40))
    want = _preempt_run(_jax_engine(jcfg, jparams), prompts)
    got = _preempt_run(_engine(cfg, params), prompts)
    assert got == want
    # uid 0's two chunks insert it at step 2: 4 decode steps, paused 3,
    # then 4 more
    assert len(got[0]) == 1 + 4 + 4


def test_crash_snapshot_restore_matches_the_uncrashed_jax_run(tmp_path):
    """Snapshot every 3 steps, crash after 7, restore into a fresh
    engine (side caches and the batch's latent leaves come back), finish:
    the JAX supervisor's uncrashed tokens."""
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size, (5, 30, 9, 40, 17))
    jbat = J.RequestBatcher(batch_size=BATCH, eos_id=-1, max_len=MAX_LEN)
    for u, p in enumerate(prompts):
        jbat.submit(J.Request(uid=u, prompt=p, max_new_tokens=MAX_NEW))
    want = {r.uid: list(r.generated) for r in J.ServingSupervisor(
        _jax_engine(jcfg, jparams), jbat).serve(max_steps=80)}

    def stack():
        return (_engine(cfg, params),
                RequestBatcher(batch_size=BATCH, eos_id=-1,
                               max_len=MAX_LEN))

    eng, bat = stack()
    for u, p in enumerate(prompts):
        bat.submit(Request(uid=u, prompt=p, max_new_tokens=MAX_NEW))
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    sup = ServingSupervisor(eng, bat, ckpt=mgr, checkpoint_every=3,
                            audit_every=1)
    for _ in range(7):
        sup.step()
    assert mgr.latest_step() == 6
    del sup, eng, bat

    eng2, bat2 = stack()
    sup2 = ServingSupervisor(eng2, bat2,
                             ckpt=CheckpointManager(str(tmp_path)),
                             audit_every=1)
    sup2.restore()
    assert sup2.t == 6 and audit_engine(eng2, bat2) == []
    fin = sup2.serve(max_steps=100)
    assert not sup2.failed
    assert {r.uid: list(r.generated) for r in fin} == want


def test_rollback_slot_rewinds_a_latent_row():
    """One step rewound by ``rollback_slot`` and run again gives the
    same tokens: the stale latent row past the restored length is
    overwritten by the replayed append."""
    cfg, _, _, params = _weights()
    eng = _engine(cfg, params)
    for slot, p in enumerate(_prompts(cfg.vocab_size, (12, 21))):
        eng.begin_prefill(slot, p)
    while not (eng.live[0] and eng.live[1]):
        eng.step()
    ctx, tok = list(eng.row_ctx), eng.state.last_token.tolist()
    first = eng.decode_once().tolist()
    for slot in (0, 1):
        eng.rollback_slot(slot, ctx[slot], tok[slot])
    assert eng.decode_once().tolist() == first


def test_paged_engine_refuses_mla_like_jax():
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
    assert "MLA" in str(got.value)


def test_decode_path_below_2n_differs_from_jax_as_recorded(monkeypatch):
    """Recorded, not fixed (the JAX package is not edited): JAX's engine
    passes MLA no plan, so under ``attn_impl="auto"`` (the full config's;
    the smoke config pins ``xla``) ``ops._auto_dispatch`` keys each
    absorbed call on the latent buffer's length, ``max_len`` (160 > 2N =
    128): its decode fuses at every context.  The port's engine resolves on the
    host-known context (``_latent_dispatch``): below 2N the reference,
    past it #1.  At context 41 the two paths differ; past 2N they agree.
    The tokens agree either way (test_dense_token_stream_matches_jax_engine)."""
    from repro.kernels import ops as jops
    cfg, jcfg, jparams, params = _weights()
    keys = []
    auto = jops._auto_dispatch

    def spy(entry, sq, skv, d, hq, hkv, lengths_masked, interpret):
        out = auto(entry, sq, skv, d, hq, hkv, lengths_masked, interpret)
        keys.append((sq, skv, d, hq, hkv, out.path))
        return out

    monkeypatch.setattr(jops, "_auto_dispatch", spy)
    state = jax_engine.init_decode_state(jcfg, 1, MAX_LEN, jnp.float32)
    state = jax_engine.DecodeState(
        cache=state.cache, cache_len=jnp.full((1,), 40, jnp.int32),
        last_token=jnp.zeros((1,), jnp.int32))
    jax_engine.decode_step(jparams, dataclasses.replace(
        jcfg, attn_impl="auto"), state)
    latent = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert keys and set(keys) == {(1, MAX_LEN, latent, cfg.n_heads, 1,
                                   "fused_attention")}
    eng = _engine(cfg, params)
    assert 2 * latent == 128
    assert eng._latent_dispatch(1, 41).path == "unfused"
    assert eng._latent_dispatch(1, 129).path == "fused_attention"
