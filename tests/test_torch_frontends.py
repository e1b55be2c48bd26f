"""The modality-frontend slice against the JAX package, on the same
weights (``params_from_numpy`` of ``init_params_and_axes(PRNGKey(0))``)
and the same numpy inputs, in fp32 on the CPU, for the hubert-xlarge
encoder (non-causal, audio frames alone) and the internvl2-2b VLM
(patch embeddings before the text), at their smoke configs:

* ``forward(embeds=...)`` (and with tokens after the embeddings): the
  logits within 1e-4;
* ``serve.engine.prefill(embeds=...)`` then 4 ``decode_step``s, with and
  without the serving plan: identical tokens, logits within 1e-4;
* ``train.step`` on the embeds batches (the encoder's ``targets``, the
  VLM's text-suffix loss): the loss, every gradient leaf and the
  parameters after one AdamW step within 1e-5 (the parameters whose
  gradient lies within 1e-3 of its leaf's largest, where AdamW's first
  step divides by the element's own magnitude, within 2 lr);
* ``launch.train.train_loop`` on hubert's token batches and
  ``launch.serve.run`` for both archs: the JAX launchers' losses and
  tokens;
* the non-causal flag reaching every attention call of hubert's paths,
  none refused onto the reference; ``check_ported`` admitting MoE and
  still refusing MLA and the hybrid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.models import transformer as jax_tf
from repro.optim import adamw_init as jax_adamw_init
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestBatcher as JaxBatcher
from repro.serve import engine as jax_engine
from repro.train import step as jax_step

from repro_torch import configs, lower, tree
from repro_torch.kernels import ops
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.serve import engine
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCHS = ["hubert-xlarge", "internvl2-2b"]
ATOL = 1e-4
#: train_step's tolerance: loss relative, each gradient leaf against its
#: largest magnitude, parameters after the AdamW step absolute
TRAIN_TOL = 1e-5


def _weights(arch, **over):
    jcfg = dataclasses.replace(jax_configs.get_config(arch, smoke=True),
                               **over)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **{k: v for k, v in over.items()
                                 if k != "attn_impl"})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _weights(request.param)


def _embeds(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.frontend_dim)).astype(np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _inputs(cfg, b, s_f, s_t):
    """(embeds, tokens) of a prompt: hubert's frames alone, internvl's
    patches before text."""
    toks = None if cfg.name.startswith("hubert") else _tokens(cfg, b, s_t)
    return _embeds(cfg, b, s_f), toks


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _t(x, long=False):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t.long() if long else t


def test_configs_match_jax_and_register():
    for arch in ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(configs.get_config(arch, smoke)) == \
                dataclasses.asdict(jax_configs.get_config(arch, smoke))
        assert configs.family(arch) == "dense"
        assert arch in configs.list_archs("dense")
    from repro.configs import internvl2_2b as jax_vl
    from repro_torch.configs import internvl2_2b as vl
    assert vl.PATCH_TOKENS == jax_vl.PATCH_TOKENS == 256


def test_params_carry_the_frontend_projection(model):
    cfg, _, jparams, params = model
    fp = params["frontend_proj"]
    assert tuple(fp.shape) == (cfg.frontend_dim, cfg.d_model)
    np.testing.assert_array_equal(fp.numpy(),
                                  np.asarray(jparams["frontend_proj"]))
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("with_tokens", [False, True])
def test_forward_with_embeds_matches_jax(model, with_tokens):
    """Embeddings alone, and embeddings before 11 tokens: the same
    logits over the concatenated rows."""
    cfg, jcfg, jparams, params = model
    emb = _embeds(cfg, 2, 37)
    toks = _tokens(cfg, 2, 11) if with_tokens else None
    want = jax_tf.forward(jparams, jcfg, tokens=_jnp(toks),
                          embeds=jnp.asarray(emb))
    got = tf.forward(params, cfg, _t(toks, long=True), _t(emb))
    assert got.shape == (2, 37 + (11 if with_tokens else 0), cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("planned", [False, True])
def test_prefill_with_embeds_and_4_decode_steps_match_jax(model, planned):
    """A prompt of 40 embedding rows (and 30 tokens for the VLM): past
    2N = 64 for the smoke head width with the tokens, so the planned run
    takes the fused paths; ``cache_len`` counts every row."""
    cfg, jcfg, jparams, params = model
    b, max_len = 2, 96
    emb, toks = _inputs(cfg, b, 40, 30)
    rows = 40 + (0 if toks is None else 30)
    jplan = jax_engine.make_serving_plan(jcfg, max_len) if planned else None
    plan = engine.make_serving_plan(cfg, max_len, device="cpu") \
        if planned else None
    jstate = jax_engine.init_decode_state(jcfg, b, max_len, jnp.float32,
                                          plan=jplan)
    state = engine.init_decode_state(cfg, b, max_len, torch.float32,
                                     plan=plan, device="cpu")
    jstate = jax_engine.prefill(jparams, jcfg, _jnp(toks), jstate,
                                embeds=jnp.asarray(emb), plan=jplan)
    state = engine.prefill(params, cfg, _t(toks, long=True), state,
                           embeds=_t(emb), plan=plan)
    assert state.cache_len.tolist() == [rows] * b
    assert state.last_token.tolist() == np.asarray(jstate.last_token).tolist()
    for step in range(4):
        jstate, jl = jax_engine.decode_step(jparams, jcfg, jstate,
                                            plan=jplan)
        state, lg = engine.decode_step(params, cfg, state, plan=plan)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        assert state.last_token.tolist() == \
            np.asarray(jstate.last_token).tolist()
    assert state.cache_len.tolist() == [rows + 4] * b
    if planned:
        assert [r[:4] for r in plan.resolutions] == \
            [r[:4] for r in jplan.resolutions]
        assert plan.resolutions[0][3] == lower.FUSED_ATTENTION


def _train_batch(cfg, b=2):
    """hubert: {"embeds", "targets"} over 24 frames; internvl: 16 patch
    rows and 21 tokens (20 text rows, the loss on their 20 targets)."""
    if cfg.name.startswith("hubert"):
        return {"embeds": _embeds(cfg, b, 24, seed=3),
                "targets": _tokens(cfg, b, 24, seed=4)}
    return {"embeds": _embeds(cfg, b, 16, seed=3),
            "tokens": _tokens(cfg, b, 21, seed=4)}


def _port_batch(batch):
    return {k: _t(v, long=v.dtype == np.int32) for k, v in batch.items()}


def test_train_step_on_embeds_batches_matches_jax(model):
    cfg, jcfg, jparams, params = model
    batch = _train_batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jtot, jm), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, jbatch), has_aux=True)(jparams)
    (tot, m), grads = port_step.value_and_grad(params, cfg,
                                               _port_batch(batch))
    assert float(tot) == pytest.approx(float(jtot), rel=TRAIN_TOL)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=TRAIN_TOL)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    zero = 0
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        zero += scale == 0      # hubert's token embedding: no tokens
        assert np.abs(got.numpy() - want).max() <= TRAIN_TOL * scale
    assert zero == (1 if "tokens" not in batch else 0)

    jstate = jax_step.TrainState(params=jparams,
                                 opt=jax_adamw_init(jparams))
    jstate, jmet = jax_step.train_step(jstate, jbatch, jcfg, lr=1e-3)
    state = port_step.init_train_state(
        None, cfg, device="cpu",
        params=tree.map(lambda p: p.clone(), params))
    state, met = port_step.train_step(state, _port_batch(batch), cfg,
                                      lr=1e-3)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=TRAIN_TOL)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=TRAIN_TOL)
    # AdamW's first update is lr * g / (|g| + eps): an element whose
    # gradient is within the gradients' own agreement of 0 may move by
    # up to 2 lr; every other element is held to TRAIN_TOL
    for want, got, g in zip(jax.tree.leaves(jstate.params),
                            tree.leaves(state.params),
                            jax.tree.leaves(jgrads)):
        g = np.abs(np.asarray(g))
        err = np.abs(got.numpy() - np.asarray(want))
        small = g <= 1e-3 * g.max()
        assert (err[~small] <= TRAIN_TOL).all(), err[~small].max()
        assert (err[small] <= 2e-3).all()


def test_vlm_loss_covers_the_text_suffix_only():
    """The VLM's loss is the cross entropy of the text rows' logits: the
    patch rows' logits do not enter it."""
    cfg, _, _, params = _weights("internvl2-2b")
    batch = _port_batch(_train_batch(cfg))
    total, _ = port_step.loss_fn(params, cfg, batch)
    toks = batch["tokens"]
    logits = tf.forward(params, cfg, toks[:, :-1], batch["embeds"])
    text = logits[:, batch["embeds"].shape[1]:]
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1))
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)


def test_microbatches_take_the_batch_size_from_the_embeds(monkeypatch):
    """hubert's batch has no tokens: ``microbatches=2`` slices its embeds
    and targets in two.  The gradients that reach AdamW are the mean of
    the halves', equal to the full batch's within 1e-6 of each leaf's
    largest; the step matches JAX's ``train_step(..., microbatches=2)``
    on the same batch (grad_norm and parameters as in the one-batch
    test)."""
    cfg, jcfg, jparams, params = _weights("hubert-xlarge")
    batch = _train_batch(cfg, b=4)
    seen = []
    adamw = port_step.adamw_update

    def spy(p, grads, *a, **kw):
        seen.append(tree.map(torch.clone, grads))
        return adamw(p, grads, *a, **kw)

    monkeypatch.setattr(port_step, "adamw_update", spy)
    state = port_step.init_train_state(
        None, cfg, device="cpu",
        params=tree.map(lambda p: p.clone(), params))
    state, met = port_step.train_step(state, _port_batch(batch), cfg,
                                      lr=1e-3, microbatches=2)
    _, full = port_step.value_and_grad(params, cfg, _port_batch(batch))
    (acc,) = seen
    for a, want in zip(tree.leaves(acc), tree.leaves(full)):
        assert a.dtype == torch.float32
        scale = want.abs().max().item()
        assert (a - want).abs().max().item() <= 1e-6 * scale

    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate = jax_step.TrainState(params=jparams,
                                 opt=jax_adamw_init(jparams))
    jstate, jmet = jax_step.train_step(jstate, jbatch, jcfg, lr=1e-3,
                                       microbatches=2)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=TRAIN_TOL)
    jfull = jax.grad(lambda p: jax_step.loss_fn(p, jcfg, jbatch)[0])(jparams)
    for want, got, g in zip(jax.tree.leaves(jstate.params),
                            tree.leaves(state.params),
                            jax.tree.leaves(jfull)):
        g = np.abs(np.asarray(g))
        err = np.abs(got.numpy() - np.asarray(want))
        small = g <= 1e-3 * g.max()
        assert (err[~small] <= TRAIN_TOL).all(), err[~small].max()
        assert (err[small] <= 2e-3).all()


def test_train_loop_on_hubert_tokens_matches_jax():
    """``launch.train`` trains hubert on token batches as the JAX
    launcher does: non-causal, ``targets = tokens``."""
    cfg, jcfg, _, params = _weights("hubert-xlarge")
    kw = dict(steps=4, batch=2, seq=24, lr=1e-3, log_every=100)
    _, want = jax_train.train_loop(jcfg, **kw)
    _, got = port_train.train_loop(cfg, device="cpu", params=params, **kw)
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert "hubert-xlarge" in port_train.parser()._option_string_actions[
        "--arch"].choices


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


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_tokens_match_jax(arch):
    """``launch.serve`` serves both archs on token prompts, as the JAX
    launcher does: the same prompts and generated tokens.  A prompt of
    4-11 tokens and chunks of 8 run the masked kernels' plain versions
    across chunk and decode steps."""
    cfg, jcfg, jparams, params = _weights(arch)
    args = port_serve.parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5",
         "--max-new", "6", "--max-len", "64", "--prefill-chunk", "8",
         "--batch", "3"])
    want = _jax_serve_main(jcfg, jparams, args)
    out = port_serve.run(args, cfg, params,
                         port_serve.make_requests(cfg, args.requests,
                                                  args.max_new))
    got = {r.uid: (r.prompt, r.generated) for r in out["finished"]}
    assert got == want and len(got) == 5


def test_noncausal_flag_reaches_every_attention_call(monkeypatch):
    """hubert's cache-free forward, its cached prefill, a later chunk
    and its decode steps: every ``ops`` attention entry is called with
    ``causal=False`` (the masked kernels, #2 on the later chunk, the
    decode megakernel has no mask to pass), and none is refused onto the
    reference."""
    cfg, jcfg, jparams, params = _weights("hubert-xlarge")
    seen = []
    for entry in ("attention", "qproj_attention"):
        fn = getattr(ops, entry)

        def spy(*a, _fn=fn, _entry=entry, **kw):
            seen.append((_entry, kw.get("causal"), kw.get("lengths")
                         is not None))
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, entry, spy)
    emb = torch.from_numpy(_embeds(cfg, 1, 70))
    ops.reset_counts()
    with torch.no_grad():
        tf.forward(params, cfg, None, emb)
    plan = engine.make_serving_plan(cfg, 160, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 110)).long()
    state = engine.init_decode_state(cfg, 1, 160, torch.float32, plan=plan,
                                     device="cpu")
    state = engine.prefill(params, cfg, None, state, embeds=emb, plan=plan)
    state = engine.chunked_prefill(params, cfg, toks, state, chunk_size=48,
                                   plan=plan)
    for _ in range(3):
        state, _ = engine.decode_step(params, cfg, state, plan=plan)
    assert {(e, m) for e, _, m in seen} == {("attention", False),
                                           ("attention", True),
                                           ("qproj_attention", True)}
    assert all(c is False for _, c, _ in seen)
    assert not any(d.plan.downgrades for d in (
        plan.prefill_dispatch(70), plan.chunk_dispatch(118, 48),
        plan.chunk_dispatch(180, 48), plan.decode_dispatch(160)))
    for entry in ("attention", "qproj_attention", "decode_block"):
        assert ops.CALLS[(entry, "torch")] > 0, entry


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("arch,what", [
    ("phi3.5-moe-42b-a6.6b", "MoE"), ("deepseek-v3-671b", "MLA"),
    ("jamba-1.5-large-398b", "hybrid")])
def test_check_ported_admits_moe_and_refuses_mla_and_the_hybrid(arch,
                                                                 what):
    """MoE, (since the MLA slice) MLA and (since the hybrid slice) the
    attention/Mamba-2 hybrid stacks are admitted, smoke and full; the
    hybrid with an attention flavour the port does not run is refused."""
    cfg = _port_cfg(jax_configs.get_config(arch, smoke=True))
    tf.check_ported(cfg)
    tf.check_ported(_port_cfg(jax_configs.get_config(arch)))
    if what == "hybrid":
        with pytest.raises(NotImplementedError, match="GQA or MLA"):
            tf.check_ported(dataclasses.replace(cfg, attention="none"))
    if what == "MLA":
        mla = dataclasses.replace(configs.get_config("qwen3-8b", smoke=True),
                                  attention="mla")
        tf.check_ported(mla)
        tf.check_ported(configs.get_config("deepseek-v3-671b"))
    for ok in ARCHS:
        tf.check_ported(configs.get_config(ok))
