"""``remat="dots"``: the port's selective checkpoint against JAX's
``dots_with_no_batch_dims_saveable``, in fp32 on the CPU at the smoke
configs, on the same weights and numpy batches:

* its gradients equal ``"none"``'s and ``"full"``'s within 1e-6, and
  JAX's ``remat="dots"`` gradients within 1e-5 of each leaf's largest;
* what it keeps: after the forward, the selective checkpoint's storage
  holds exactly each layer's projection outputs (q, k, v, o and the
  MLP's up, gate and down products, as 2-D ``aten.mm`` results), and a
  ``saved_tensors_hooks`` count sees the same tensors saved outside the
  layers as under ``"full"``;
* a 3-D ``x @ W`` and the attention projections reach ``aten.mm`` (not
  ``aten.bmm``, which the policy would not keep);
* ``"dots_saveable"`` and an unknown policy raise ``ValueError``.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import mlp_forward
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.train import step as port_step

torch.set_num_threads(2)

#: the frontends (encoder, VLM), a GELU decoder and a qk-norm decoder
ARCHS = ["hubert-xlarge", "internvl2-2b", "starcoder2-7b", "qwen3-8b"]


def _weights(arch, remat):
    jcfg = dataclasses.replace(jax_configs.get_config(arch, smoke=True),
                               remat=remat)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              remat=remat)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, jparams, params


def _batch(cfg, b=2, s=40):
    """Token batches for the decoders; hubert's frames and targets;
    internvl's patches before text."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    if cfg.frontend == "none":
        return {"tokens": toks}
    emb = rng.standard_normal((b, 16, cfg.frontend_dim)).astype(np.float32)
    if cfg.causal:
        return {"embeds": emb, "tokens": toks}
    return {"embeds": emb, "targets": toks[:, :16]}


def _port(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _grads(arch, remat, batch=None):
    cfg, _, _, params = _weights(arch, remat)
    batch = batch or _batch(cfg)
    (loss, _), grads = port_step.value_and_grad(params, cfg, _port(batch))
    return loss, tree.leaves(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_equal_none_and_full(arch):
    loss, dots = _grads(arch, "dots")
    for other in ("none", "full"):
        lo, grads = _grads(arch, other)
        assert torch.equal(lo, loss)
        for a, b in zip(dots, grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_match_jax_dots(arch):
    cfg, jcfg, jparams, params = _weights(arch, "dots")
    batch = _batch(cfg)
    (jtot, _), jgrads = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jparams)
    (tot, _), grads = port_step.value_and_grad(params, cfg, _port(batch))
    assert float(tot) == pytest.approx(float(jtot), rel=1e-5)
    for want, got in zip(jax.tree.leaves(jgrads), tree.leaves(grads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def _projections(cfg, rows):
    """The (rows, width) outputs of one layer's 2-D products: q, k, v,
    o, then the MLP's."""
    h, hk, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    mlp = [cfg.d_ff] * (2 if cfg.mlp == "silu_glu" else 1) + [cfg.d_model]
    return sorted([(rows, h * d), (rows, hk * d), (rows, hk * d),
                   (rows, cfg.d_model)] + [(rows, w) for w in mlp])


def _sac_kept():
    """Shapes of the tensors the selective checkpoints hold for the
    backward (their storage's wrapped entries, found by the collector)."""
    from torch.utils.checkpoint import _VersionWrapper
    return sorted(tuple(o.val.shape) for o in gc.get_objects()
                  if type(o) is _VersionWrapper
                  and isinstance(o.val, torch.Tensor))


def _forward_saving(cfg, params, batch):
    """Run the loss forward with autograd on, counting the tensors
    autograd saves outside the layers' checkpoints; returns (loss,
    count)."""
    leaves = port_step._trainable(params, tree.map(torch.zeros_like,
                                                   params))
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = port_step.loss_fn(leaves, cfg, _port(batch))
    return total, count[0]


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_dots_keeps_exactly_each_layers_projection_outputs(arch):
    cfg, _, _, params = _weights(arch, "dots")
    batch = _batch(cfg)
    rows = 2 * (16 + (40 if "tokens" in batch else 0))
    gc.collect()
    assert _sac_kept() == []
    total, outside = _forward_saving(cfg, params, batch)
    kept = _sac_kept()
    assert kept == sorted(_projections(cfg, rows) * cfg.n_layers)
    assert len(kept) == cfg.n_layers * (7 if cfg.mlp == "silu_glu" else 6)
    total.backward()
    del total
    gc.collect()
    assert _sac_kept() == []            # consumed by the backward
    full = dataclasses.replace(cfg, remat="full")
    total, outside_full = _forward_saving(full, params, batch)
    assert _sac_kept() == [] and outside == outside_full
    none = dataclasses.replace(cfg, remat="none")
    _, outside_none = _forward_saving(none, params, batch)
    assert outside_none > outside


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_projections_reach_aten_mm_not_bmm():
    """``x @ W`` with x (B, S, E) folds to one ``aten.mm``; so do the
    attention's q/k/v/o projections and the MLP's products, so the
    policy sees and keeps each (with ``aten.bmm`` it would keep
    nothing and ``dots`` would equal ``full``)."""
    cfg = configs.get_config("internvl2-2b", smoke=True)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = tf._index(p["layers"][0], 0)
    x = torch.randn(2, 9, cfg.d_model, requires_grad=True)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    for fn in (lambda: attn._heads(x, lp["attn"]["wq"]),
               lambda: x @ lp["mlp"]["w_up"],
               lambda: mlp_forward(lp["mlp"], x, cfg.mlp)):
        with _Ops() as mode:
            fn()
        assert mm in mode.seen and bmm not in mode.seen
    pos = torch.arange(9)[None].expand(2, 9)
    with _Ops() as mode:
        attn.gqa_forward(lp["attn"], cfg, x, pos, residual=x, impl="torch")
    assert mode.seen.count(mm) == 4         # q, k, v, o
    assert tf.dots_policy(None, mm) == tf.CheckpointPolicy.MUST_SAVE
    assert tf.dots_policy(None, bmm) == \
        tf.CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("remat", ["dots_saveable", "everything"])
def test_unknown_remat_policies_raise(remat):
    cfg = dataclasses.replace(configs.get_config("hubert-xlarge",
                                                 smoke=True), remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=remat):
        port_step.value_and_grad(params, cfg, _port(_batch(cfg)))
