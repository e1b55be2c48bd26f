"""phi3.5-moe's smoke config served by the port's engines against the JAX
package's, on the same weights, in fp32 on the CPU.  Prefill runs in
chunks of 16 tokens, so each chunk routes with its own capacity
(``int(16·k/E·cf)``), and decode with one token a row (capacity 8):

* a planned chunked prefill and 4 decode steps: each chunk's logits and
  each step's within 1e-4, the same tokens, the plan's paths;
* the dense engine's token stream (4 requests of 44-90 tokens through
  the batcher, batch 3) and ``launch.serve.run``'s: JAX's tokens;
* the paged engine's stream, with a pool that forces a preempt and its
  resume: JAX's paged engine's tokens, preemptions and peak pool use,
  and the port's dense engine's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import lower as jax_lower
from repro.models import transformer as jax_tf
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import PagedContinuousBatchingEngine as JaxPagedEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestBatcher as JaxBatcher
from repro.serve import engine as jax_engine
from repro.serve import make_serving_plan as jax_serving_plan

from repro_torch import configs, lower
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as tf
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine,
                               PagedContinuousBatchingEngine, Request,
                               RequestBatcher)
from repro_torch.serve import engine
from repro_torch.serve.engine import make_serving_plan

torch.set_num_threads(2)

ARCH = "phi3.5-moe-42b-a6.6b"
ATOL = 1e-4
CHUNK = 16

_WEIGHTS: dict = {}


def _weights():
    """(port cfg, JAX cfg, JAX params, port params) of the smoke config,
    shared by this module's tests."""
    if not _WEIGHTS:
        jcfg = jax_configs.get_config(ARCH, smoke=True)
        jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_config(ARCH, smoke=True)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _WEIGHTS["w"] = (cfg, jcfg, jparams, params)
    return _WEIGHTS["w"]


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def test_chunked_prefill_and_decode_logits_match_jax():
    """A 70-token prompt in chunks of 16 (the last of 6) and 4 decode
    steps past 2N = 64, planned: each chunk's and step's logits within
    1e-4, the same tokens and plan resolutions."""
    cfg, jcfg, jparams, params = _weights()
    b, max_len = 2, 96
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, 70)).astype(np.int32)
    jplan = jax_engine.make_serving_plan(jcfg, max_len)
    plan = make_serving_plan(cfg, max_len, device="cpu")
    jstate = jax_engine.init_decode_state(jcfg, b, max_len, jnp.float32,
                                          plan=jplan)
    state = engine.init_decode_state(cfg, b, max_len, torch.float32,
                                     plan=plan, device="cpu")
    jcache, cache = jstate.cache, state.cache
    for start in range(0, 70, CHUNK):
        piece = toks[:, start:start + CHUNK]
        rows = piece.shape[1]
        jl, jcache = jax_tf.forward(
            jparams, jcfg, tokens=jnp.asarray(piece), cache=jcache,
            cache_len=start, plan=jplan.chunk_dispatch(start + rows, rows))
        lg, cache = tf.forward(
            params, cfg, torch.from_numpy(piece).long(), cache=cache,
            cache_len=start, plan=plan.chunk_dispatch(start + rows, rows))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {start}")
    jstate = jax_engine.DecodeState(
        cache=jcache, cache_len=jnp.full((b,), 70, jnp.int32),
        last_token=jax_engine.greedy_sample(jl))
    state = engine.DecodeState(
        cache=cache, cache_len=torch.full((b,), 70, dtype=torch.int32),
        last_token=engine.greedy_sample(lg))
    for step in range(4):
        jstate, jl = jax_engine.decode_step(jparams, jcfg, jstate,
                                            plan=jplan)
        state, lg = engine.decode_step(params, cfg, state, plan=plan)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        assert state.last_token.tolist() == \
            np.asarray(jstate.last_token).tolist()
    assert [r[:4] for r in plan.resolutions] == \
        [r[:4] for r in jplan.resolutions]
    assert {lower.QPROJ_ATTENTION, lower.DECODE_MEGAKERNEL} <= \
        {r[3] for r in plan.resolutions}


MAX_LEN, BATCH, MAX_NEW = 160, 3, 6


def test_dense_token_stream_matches_jax_engine():
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size, [44, 90, 71, 58], seed=7)
    jeng = JaxEngine(jparams, jcfg, batch_size=BATCH, max_len=MAX_LEN,
                     plan=jax_serving_plan(jcfg, MAX_LEN),
                     prefill_chunk=CHUNK)
    jb = JaxBatcher(BATCH, max_len=MAX_LEN)
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=BATCH, max_len=MAX_LEN,
        plan=make_serving_plan(cfg, MAX_LEN, device="cpu"),
        prefill_chunk=CHUNK, device="cpu")
    b = RequestBatcher(BATCH, max_len=MAX_LEN)
    for uid, p in enumerate(prompts):
        jb.submit(JaxRequest(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    want = {r.uid: r.generated for r in jb.serve(jeng, max_steps=200)}
    ops.reset_counts()
    got = {r.uid: r.generated for r in b.serve(eng, max_steps=200)}
    assert got == want and len(got) == 4
    assert all(len(t) == MAX_NEW for t in got.values())
    # 16-row chunks sit below N = 32: the first chunk runs unfused, the
    # later ones #2's plain version, decode past 2N the megakernel's
    for entry in ("qproj_attention", "decode_block"):
        assert ops.CALLS[(entry, "torch")] > 0, entry


def _jax_serve_main(jcfg, jparams, args):
    """``repro.launch.serve.main``'s loop, on given weights."""
    eng = JaxEngine(jparams, jcfg, batch_size=args.batch,
                    max_len=args.max_len,
                    plan=jax_engine.make_serving_plan(jcfg,
                                                      max_len=args.max_len),
                    dtype=jnp.dtype(jcfg.compute_dtype),
                    prefill_chunk=args.prefill_chunk)
    batcher = JaxBatcher(args.batch, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        prompt = rng.integers(0, jcfg.vocab_size,
                              size=rng.integers(4, 12)).tolist()
        batcher.submit(JaxRequest(uid=uid, prompt=prompt,
                                  max_new_tokens=args.max_new))
    done = batcher.serve(eng, max_steps=args.max_new * args.requests
                         + args.requests)
    return {r.uid: (r.prompt, r.generated) for r in done}


def test_launch_serve_tokens_match_jax():
    cfg, jcfg, jparams, params = _weights()
    args = port_serve.parser().parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5",
         "--max-new", "6", "--max-len", "64", "--prefill-chunk", "8",
         "--batch", "3"])
    want = _jax_serve_main(jcfg, jparams, args)
    out = port_serve.run(args, cfg, params,
                         port_serve.make_requests(cfg, args.requests,
                                                  args.max_new))
    got = {r.uid: (r.prompt, r.generated) for r in out["finished"]}
    assert got == want and len(got) == 5


def _counted(eng):
    counts = {"preempt": 0, "resume": 0}
    pre, res = eng.preempt, eng.resume

    def preempt(slot):
        counts["preempt"] += 1
        return pre(slot)

    def resume(p, slot):
        counts["resume"] += 1
        return res(p, slot)

    eng.preempt, eng.resume = preempt, resume
    return counts


@pytest.mark.parametrize("demotions", [0, 1])
def test_paged_token_stream_matches_jax_engine(demotions):
    """Three prompts of 86, 78 and 70 tokens, batch 2, page 8, a pool of
    22 pages: the first two leases fill it, the newest is preempted at
    its first page crossing and resumes when the first finishes.  The
    decode steps past 2N run the paged megakernel (#6), or one rung down
    (#5) with ``demotions = 1``."""
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size, [86, 78, 70], seed=5)
    page, pages, max_len, budget = 8, 22, 128, 4
    jax_lower.clear_plan_cache()
    lower.clear_plan_cache()
    jeng = JaxPagedEngine(jparams, jcfg, batch_size=2, max_len=max_len,
                          plan=jax_serving_plan(jcfg, max_len, paged=True,
                                                page_size=page),
                          prefill_chunk=CHUNK, page_size=page,
                          num_pages=pages)
    eng = PagedContinuousBatchingEngine(
        params, cfg, batch_size=2, max_len=max_len,
        plan=make_serving_plan(cfg, max_len, device="cpu", paged=True,
                               page_size=page),
        prefill_chunk=CHUNK, page_size=page, num_pages=pages, device="cpu")
    dense = ContinuousBatchingEngine(
        params, cfg, batch_size=2, max_len=max_len,
        plan=make_serving_plan(cfg, max_len, device="cpu"),
        prefill_chunk=CHUNK, device="cpu")
    jeng.demotions = eng.demotions = dense.demotions = demotions
    out = []
    for e, batcher, req in ((jeng, JaxBatcher, JaxRequest),
                            (eng, RequestBatcher, Request),
                            (dense, RequestBatcher, Request)):
        counts = _counted(e)
        bt = batcher(batch_size=2, eos_id=-1, max_len=max_len)
        for uid, p in enumerate(prompts):
            bt.submit(req(uid=uid, prompt=p, max_new_tokens=budget))
        ops.reset_counts()
        done = bt.serve(e, max_steps=400)
        out.append(({r.uid: list(r.generated) for r in done}, counts,
                    dict(ops.CALLS)))
    (want, jc, _), (got, c, calls), (dense_toks, _, _) = out
    assert got == want and len(got) == 3
    assert all(len(t) == budget for t in got.values())
    assert dense_toks == got
    assert c["preempt"] == jc["preempt"] > 0
    assert c["resume"] == jc["resume"] == c["preempt"]
    assert eng.allocator.peak_used == jeng.allocator.peak_used
    entry = "qproj_attention" if demotions else "decode_block"
    assert calls[(f"{entry}_paged", "torch")] > 0
