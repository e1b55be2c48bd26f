"""Mamba-2 training in the port against the JAX package, on the same
weights (``params_from_numpy`` of ``init_params_and_axes(PRNGKey(0))``)
and numpy tokens, fp32 on the CPU.

The JAX package trains a Mamba-2 stack off the TPU through its
differentiable lax scan (``ops.ssd``'s ``auto`` is ``xla`` there); the
Pallas kernel has no backward.  The port decides the same on the grad
mode: under autograd ``ops.ssd(impl="auto")`` is the plain scan on
either device, counted as ``("ssd", "torch")``, and the kernel (#11,
``ssd_scan``, ``impl="cuda"``) refuses a tracked input.

* ``ops.ssd``'s gradients of every input against ``jax.grad`` of
  ``xla_fallback.chunked_ssd`` (with h0): within 1e-5 of each one's
  largest;
* mamba2-smoke's loss and every gradient leaf of ``train_step`` against
  JAX's ``loss_fn`` under none, full and dots (1e-5 of each leaf's
  largest), the scan counted once a layer (twice under remat);
* ``train_loop``'s losses against JAX's (1e-5);
* a 30-step run crashed after step 12 and restored from its checkpoint
  equals the uninterrupted run bit for bit (``tests/test_system.py``'s
  case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import xla_fallback as jxla
from repro.launch import train as jax_train
from repro.models import transformer as jax_tf
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenDataset
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.launch import train as port_train
from repro_torch.models.weights import params_from_numpy
from repro_torch.train import step as port_step

torch.set_num_threads(2)

ARCH = "mamba2-130m"
TRAIN_TOL = 1e-5


def _weights(**over):
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH, smoke=True),
                               **over)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **over)
    return cfg, jcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _ssd_inputs(B=2, L=40, H=4, P=8, G=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((B, L, H, P)).astype(f),
            (np.log1p(np.exp(rng.standard_normal((B, L, H)))) * 0.1
             ).astype(f),
            (-np.exp(rng.standard_normal(H))).astype(f),
            (rng.standard_normal((B, L, G, S)) * 0.3).astype(f),
            (rng.standard_normal((B, L, G, S)) * 0.3).astype(f),
            rng.standard_normal(H).astype(f),
            (rng.standard_normal((B, H, P, S)) * 0.5).astype(f)]


def test_ssd_gradients_match_jax_chunked_ssd(monkeypatch):
    """``ops.ssd(impl="auto")`` on tracked inputs runs the plain scan, never
    the kernel's wrapper, counted as ("ssd", "torch"); the gradients of
    a weighted sum of y and the final state reach x, dt, a, b, c, d and
    h0 and equal ``jax.grad`` of the lax chunked scan's."""
    arrays = _ssd_inputs()
    rng = np.random.default_rng(1)
    wy = rng.standard_normal(arrays[0].shape).astype(np.float32)
    wh = rng.standard_normal(arrays[6].shape).astype(np.float32)

    def jloss(*args):
        y, h = jxla.chunked_ssd(*args[:6], chunk=16, h0=args[6],
                                return_final_state=True)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=tuple(range(7)))(
        *map(jnp.asarray, arrays))
    refused = []
    monkeypatch.setattr(ssd_mod, "ssd_scan",
                        lambda *a, **kw: refused.append(1))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ops.reset_counts()
    y, h = ops.ssd(*ts[:6], chunk=16, h0=ts[6], return_final_state=True)
    ((y * torch.from_numpy(wy)).sum()
     + (h * torch.from_numpy(wh)).sum()).backward()
    assert dict(ops.CALLS) == {("ssd", "torch"): 1} and not refused
    for name, t, w in zip("x dt a b c d h0".split(), ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= TRAIN_TOL * np.abs(w).max(), (name, err)


def test_kernel_refuses_grad_and_auto_follows_the_grad_mode():
    """#11 has no backward: ``ssd_scan`` and ``ops.ssd(impl="cuda")``
    raise on a tracked input, before any launch; with autograd off the
    same tensors are not tracked, and ``auto`` is the device's choice
    (the plain version on the CPU)."""
    x, dt, a, b, c, d, _ = map(torch.from_numpy, _ssd_inputs(L=8))
    x.requires_grad_()
    for call in (lambda: ssd_mod.ssd_scan(x, dt, a, b, c, d, chunk=8),
                 lambda: ops.ssd(x, dt, a, b, c, d, chunk=8, impl="cuda")):
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
    ops.reset_counts()
    with torch.no_grad():
        ops.ssd(x, dt, a, b, c, d, chunk=8)
        assert ssd_mod.tracked({"x": x}) == []
    assert ssd_mod.tracked({"x": x, "dt": dt}) == ["x"]
    assert dict(ops.CALLS) == {("ssd", "torch"): 1}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_matches_jax_under_each_remat(remat):
    cfg, jcfg, jparams, params = _weights(remat=remat)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)
    (jtot, jm), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    ops.reset_counts()
    (tot, m), grads = port_step.value_and_grad(
        params, cfg, {"tokens": torch.from_numpy(toks).long()})
    runs = 1 if remat == "none" else 2          # the recompute
    assert dict(ops.CALLS) == {("ssd", "torch"): cfg.n_layers * runs}
    assert float(tot) == pytest.approx(float(jtot), rel=TRAIN_TOL)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=TRAIN_TOL)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= TRAIN_TOL * scale


def test_train_loop_losses_match_jax():
    cfg, jcfg, _, params = _weights()
    kw = dict(steps=4, batch=4, seq=48, lr=1e-3, log_every=100)
    _, want = jax_train.train_loop(jcfg, **kw)
    _, got = port_train.train_loop(cfg, device="cpu", params=params, **kw)
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=0)


def test_crash_restart_bitwise_identical(tmp_path):
    """30 steps uninterrupted against 12 steps, a checkpoint, a "crash",
    a restore into a fresh state and 18 more: every parameter equal bit
    for bit (deterministic data, optimizer and checkpoint)."""
    cfg = configs.get_config(ARCH, smoke=True)
    ds = SyntheticTokenDataset(cfg.vocab_size, 24, 4, seed=1)

    def fresh():
        return port_step.init_train_state(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")

    def run(state, start, stop):
        for step in range(start, stop):
            batch = {"tokens": torch.from_numpy(ds.batch(step)).long()}
            state, _ = port_step.train_step(state, batch, cfg, lr=1e-3)
        return state

    ref = run(fresh(), 0, 30)
    ckpt = CheckpointManager(str(tmp_path))
    st = run(fresh(), 0, 12)
    ckpt.save(11, st, extras={"next_step": 12}, blocking=True)
    del st                                      # "crash"
    restored, extras = ckpt.restore(fresh())
    out = run(restored, extras["next_step"], 30)
    for a, b in zip(tree.leaves(ref.params), tree.leaves(out.params)):
        assert torch.equal(a, b)
    assert int(out.opt.step) == int(ref.opt.step) == 30
