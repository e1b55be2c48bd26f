"""jamba-1.5's attention/Mamba-2 hybrid (smoke config) served by the
port against the JAX package, on the same weights, fp32 on the CPU.
Neither package has a serving plan for the hybrid: each attention call
resolves the shape-only plan keyed on the K buffer's length (the
cache's ``max_len``), as JAX's ``_auto_dispatch`` keys on
``k.shape[2]`` under ``attn_impl="auto"``.

* the dense engine's token stream (with the dispatch each call took,
  against JAX's for the same key), a preempt/resume that carries a
  row's K/V, conv tail and fp32 SSM state, a crash restored from a
  snapshot (the JAX supervisor's uncrashed tokens) and
  ``launch.serve.run``: JAX's tokens.

The JAX engine runs its ``forward`` under ``jax.jit`` here
(``_jitted_forward``): called eagerly, each call compiles its layer scan
anew, about 2 s a call at these widths.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as jax_configs
from repro.kernels import ops as jops
from repro.models import transformer as jax_tf

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine, Request,
                               RequestBatcher, ServingSupervisor,
                               audit_engine)
from repro_torch.serve import engine

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
CHUNK, MAX_LEN, BATCH, MAX_NEW = 16, 160, 3, 6
PROMPT_LENS = (33, 48, 49, 40)

_W: dict = {}
_JIT: dict = {}
_FORWARD = jax_tf.forward


def _jitted_forward(params, cfg, tokens=None, embeds=None, *,
                    cache_len=None, **kw):
    """JAX's ``forward`` under ``jax.jit``, kept across tests: an int
    ``cache_len`` (a prefill chunk's) static, a decode step's (B,) array
    traced."""
    static = not isinstance(cache_len, jax.Array)
    if static not in _JIT:
        _JIT[static] = jax.jit(_FORWARD, static_argnames=(
            "cfg", "interpret", "return_aux", "plan")
            + (("cache_len",) if static else ()))
    return _JIT[static](params, cfg, tokens, embeds, cache_len=cache_len,
                        **kw)


@pytest.fixture(autouse=True)
def _jit_and_no_injector(monkeypatch):
    ops.set_fault_injector(None)
    monkeypatch.setattr(jax_tf, "forward", _jitted_forward)
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


def test_dense_token_stream_matches_jax_engine(monkeypatch):
    """The dense engine's tokens are JAX's.  No plan: each attention call
    resolves the shape-only plan keyed on the K buffer's length, the
    cache's max_len, and takes the path JAX's ``_auto_dispatch`` gives
    that key (JAX's engine reaches it under ``attn_impl="auto"``, the
    full config's; the smoke config pins ``xla``); every Mamba layer
    scans each multi-token chunk."""
    cfg, jcfg, jparams, params = _weights()
    prompts = _prompts(cfg.vocab_size)
    want = _serve(_jax_engine(jcfg, jparams), J.RequestBatcher, J.Request,
                  prompts)
    keyed = []
    auto = ops._auto_dispatch

    def spy(entry, sq, skv, d, hq, hkv, lengths_masked, device):
        out = auto(entry, sq, skv, d, hq, hkv, lengths_masked, device)
        keyed.append(((entry, sq, skv, d, hq, hkv, lengths_masked),
                      out.path))
        return out

    monkeypatch.setattr(ops, "_auto_dispatch", spy)
    ops.reset_counts()
    got = _serve(_engine(cfg, params), RequestBatcher, Request, prompts)
    assert got == want and len(got) == 4
    assert all(len(t) == MAX_NEW for t in got.values())
    assert keyed and {k[2] for k, _ in keyed} == {MAX_LEN}
    for key, path in set(keyed):
        assert jops._auto_dispatch(*key, interpret=True).path == path, key
    assert {sq for (_, sq, *_), _ in keyed} >= {1, CHUNK}
    chunks = sum(sum(1 for st in range(0, n, CHUNK) if n - st > 1)
                 for n in PROMPT_LENS)
    assert ops.CALLS[("ssd", "torch")] == 7 * chunks
    assert ops.CALLS[("ssd_step", "torch")] > 0
    assert ops.CALLS[("attention", "torch")] > 0


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
    assert sorted(pre.kv["scan"][3]["attn"]) == ["k", "v"]
    assert sorted(pre.kv["scan"][0]["mamba"]) == ["conv", "ssm"]
    del owner[0]
    for _ in range(3):
        step()
    eng.resume(pre, 2)
    owner[2] = 0
    for _ in range(4):
        step()
    return toks


def test_dense_preempt_resume_of_a_hybrid_row_matches_jax():
    """A row's K/V, conv tail and SSM state leave with the preempt and
    come back with the resume: JAX's tokens."""
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
    engine (side caches and the batch's K/V, conv and SSM leaves come
    back), finish: the JAX supervisor's uncrashed tokens."""
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


