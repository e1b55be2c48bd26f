"""The port's training path against the JAX package's, on the same
weights (``params_from_numpy`` of ``init_params_and_axes(PRNGKey(0))``)
and the same numpy tokens, in fp32 on the CPU:

* the loss and every gradient leaf of ``train.step.loss_fn`` for the
  qwen3-8b and starcoder2-7b smoke configs at seq 96 (> their head width
  32, the M > N path), JAX through its Pallas kernels in interpret
  mode: the loss within 1e-5 relative, each gradient within 1e-4 of
  its leaf's largest magnitude;
* ``remat="full"`` and ``remat="none"`` give the same gradients,
  ``remat="dots"`` runs (``tests/test_torch_remat.py`` holds it to them
  and to JAX's), and any other policy raises;
* ``train_step`` with two microbatches equals the full batch;
* ``launch.train.train_loop`` for 5 steps gives the JAX loop's losses
  within 1e-3, resumes from its own checkpoint after a failure bit for
  bit, and ``python -m repro_torch.launch.train --smoke --device cpu``
  runs.
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
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.launch import train as port_train
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCHS = configs.list_archs("dense")
SEQ = 96


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


def _tokens(cfg, b=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, SEQ + 1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg, jcfg, jparams, params = _weights(arch, attn_impl="pallas")
    toks = _tokens(cfg)
    (jtot, jm), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                                   interpret=True), has_aux=True)(jparams)
    (tot, m), grads = port_step.value_and_grad(
        params, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert float(tot) == pytest.approx(float(jtot), rel=1e-5)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    jl, jdef = jax.tree.flatten(jgrads)
    assert jax.tree.structure(grads) == jdef
    zero = 0
    for want, got in zip(jl, tree.leaves(grads)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        scale = np.abs(want).max()
        zero += scale == 0
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * scale, (want.shape, err, scale)
    # a stub frontend's projection gets no gradient from token batches
    assert zero == (cfg.frontend != "none")
    # the parameters themselves are untouched
    for a, b in zip(jax.tree.leaves(jparams), tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_remat_full_and_none_give_the_same_gradients():
    batch = None
    out = []
    for remat in ("none", "full"):
        cfg, _, _, params = _weights("starcoder2-7b", remat=remat)
        batch = batch or {"tokens": torch.from_numpy(_tokens(cfg)).long()}
        (loss, _), grads = port_step.value_and_grad(params, cfg, batch)
        out.append((loss, tree.leaves(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat,error", [("dots_saveable", ValueError),
                                          ("dot", ValueError)])
def test_remat_takes_only_what_common_names(remat, error):
    """``ModelConfig.remat`` names none, full and dots: an unknown
    policy (the JAX config comment's ``dots_saveable``, a misspelt
    ``dot``) raises ValueError."""
    cfg = dataclasses.replace(configs.get_config("starcoder2-7b",
                                                 smoke=True), remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(error, match=remat):
        port_step.value_and_grad(
            params, cfg, {"tokens": torch.from_numpy(_tokens(cfg)).long()})


def test_microbatch_accumulation_matches_full_batch():
    cfg = configs.get_config("qwen3-8b", smoke=True)
    toks = torch.from_numpy(_tokens(cfg, b=4, seed=2)).long()
    outs = []
    for mb in (1, 2):
        g = torch.Generator().manual_seed(0)
        state = port_step.init_train_state(g, cfg, device="cpu")
        state, metrics = port_step.train_step(state, {"tokens": toks}, cfg,
                                              lr=1e-3, microbatches=mb)
        outs.append(state)
    for a, b in zip(tree.leaves(outs[0].params), tree.leaves(outs[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)
    assert int(outs[1].opt.step) == 1


def test_train_loop_losses_match_jax():
    cfg, jcfg, jparams, params = _weights("qwen3-8b")
    kw = dict(steps=5, batch=4, seq=SEQ, lr=1e-3, log_every=100)
    _, want = jax_train.train_loop(jcfg, **kw)
    _, got = port_train.train_loop(cfg, device="cpu", params=params, **kw)
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got[-1] < got[0]


def test_launch_train_smoke_runs_on_cpu(capsys):
    port_train.main(["--arch", "starcoder2-7b", "--smoke", "--steps", "3",
                     "--batch", "2", "--seq", "40", "--device", "cpu",
                     "--moment-dtype", "bfloat16", "--layers", "1"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out
    assert port_train.parser().parse_args([]).device == "cuda"


def test_train_loop_resumes_from_its_checkpoint_bitwise(tmp_path):
    """A train_loop that fails after its step-3 checkpoint, then a new
    train_loop on the same directory: it resumes at step 4, and its
    losses and final parameters equal an uninterrupted run's bit for
    bit."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    kw = dict(steps=6, batch=2, seq=24, lr=1e-3, log_every=100,
              device="cpu")
    ref_state, ref = port_train.train_loop(cfg, **kw)

    def fail_at_4(step, metrics, secs):
        if step == 4:
            raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected"):
        port_train.train_loop(cfg, ckpt_dir=str(tmp_path),
                              checkpoint_every=2, on_step=fail_at_4, **kw)
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    state, losses = port_train.train_loop(cfg, ckpt_dir=str(tmp_path),
                                          checkpoint_every=2, **kw)
    assert losses == ref[4:]
    for a, b in zip(tree.leaves(ref_state), tree.leaves(state)):
        assert torch.equal(a, b)


def test_a_steps_gradients_do_not_outlive_it():
    """With the garbage collector off, every gradient buffer of a step
    is freed when the step returns: no reference cycle (such as the
    frames remat's first call pinned before ``train.step`` imported
    ``torch._dynamo`` itself) carries a step's gradients into the
    next."""
    import gc
    import weakref

    cfg = dataclasses.replace(configs.get_config("starcoder2-7b", smoke=True),
                              remat="full")
    state = port_step.init_train_state(torch.Generator().manual_seed(0),
                                       cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg)).long()
    value_and_grad, refs = port_step.value_and_grad, []

    def tracked(*a, **kw):
        out = value_and_grad(*a, **kw)
        refs.extend(weakref.ref(t) for t in tree.leaves(out[1]))
        return out

    port_step.value_and_grad = tracked
    gc.disable()
    try:
        for _ in range(2):
            state, _ = port_step.train_step(state, {"tokens": toks}, cfg,
                                            lr=1e-3)
            assert refs and all(r() is None for r in refs)
            refs.clear()
    finally:
        gc.enable()
        port_step.value_and_grad = value_and_grad
