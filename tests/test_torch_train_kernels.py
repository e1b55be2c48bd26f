"""The training kernels of the port against the JAX package's.

On the CPU each wrapper runs its plain version, so these hold the
plain PyTorch versions of kernels #7-#10 (``kernels/ref.py``
``attention_fwd_plain``, ``attention_bwd_plain``; the Q-projection
schedule) and the autograd Functions around them to the Pallas kernels
in interpret mode, on the same numpy inputs, in fp32:

* the forward's o and lse against ``_fwd``: 1e-5 (sums in other
  orders, nothing rounds), also at MLA's training widths (D 192, Dv
  128, off the 64-row grid);
* the backward's dq, dk, dv against ``_bwd`` on the same residuals and
  cotangent: 1e-4;
* ``fused_attention``'s gradients against ``jax.grad`` of the JAX
  ``fused_attention``: 2e-4, the JAX package's own tolerance
  (``test_fused_attention_grads``);
* ``fused_qproj_attention``'s forward and its four gradients: 2e-5 and
  2e-4, as ``test_qproj_fusion_forward_and_grads``.

Also the dispatch of cache-free calls in ``kernels.ops``.  The CUDA
kernels are held to these plain versions on the card by
``test_torch_cuda.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_attention as jfa
from repro.kernels import fused_qproj_attention as jfqa

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.fused_attention import (
    check_cuda_args, fused_attention, fused_attention_bwd_dkv,
    fused_attention_bwd_dq, fused_attention_fwd)
from repro_torch.kernels.fused_qproj_attention import (
    fused_qproj_attention, fused_qproj_attention_fwd)

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# b, hq, hkv, sq, skv, d, dv, causal, q_offset
CASES = [
    (2, 4, 4, 200, 200, 32, 32, True, None),     # group 1, off the grid
    (2, 6, 2, 200, 200, 32, 32, True, None),     # group 3
    (2, 6, 2, 200, 200, 32, 32, False, None),    # full attention
    (1, 6, 2, 72, 160, 32, 32, True, None),      # Sq < Skv, default anchor
    (2, 6, 2, 64, 160, 32, 32, True, 30),        # explicit q_offset
    (1, 6, 3, 96, 96, 32, 16, True, None),       # Dv != D
    (1, 2, 2, 130, 130, 192, 128, True, None),   # MLA: D 192, Dv 128
]
IDS = ["g1", "g3", "full", "suffix", "offset", "dv16", "mla"]


def _inputs(b, hq, hkv, sq, skv, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, hq, sq, d), _rand(rng, b, hkv, skv, d),
            _rand(rng, b, hkv, skv, dv), _rand(rng, b, hq, sq, dv))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,q_offset", CASES,
                         ids=IDS)
def test_forward_and_backward_plain_match_pallas(b, hq, hkv, sq, skv, d,
                                                 dv, causal, q_offset):
    q, k, v, g = _inputs(b, hq, hkv, sq, skv, d, dv)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset,
              block_q=64, block_k=64, interpret=True)
    jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        **kw)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fused_attention_fwd(tq, tk, tv, causal=causal,
                                 q_offset=q_offset)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    _close(o, jo, 1e-5)
    _close(lse, jlse, 1e-5)

    want = jfa._bwd((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo,
                     jlse), jnp.asarray(g), **kw)
    got = ref.attention_bwd_plain(tq, tk, tv, o, lse, tg, causal=causal,
                                  q_offset=q_offset)
    for x, w in zip(got, want):
        _close(x, w, 1e-4)
    # the wrappers of #8 and #9 on CPU tensors are these plain versions
    delta = ref.attention_delta(o, tg)
    dq = fused_attention_bwd_dq(tq, tk, tv, tg, lse, delta, causal=causal,
                                q_offset=q_offset)
    dk, dvv = fused_attention_bwd_dkv(tq, tk, tv, tg, lse, delta,
                                      causal=causal, q_offset=q_offset)
    for x, w in zip((dq, dk, dvv), got):
        assert torch.equal(x, w)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,q_offset",
                         CASES[1:3] + CASES[4:5] + CASES[6:],
                         ids=IDS[1:3] + IDS[4:5] + IDS[6:])
def test_fused_attention_grads_match_jax(b, hq, hkv, sq, skv, d, dv,
                                         causal, q_offset):
    q, k, v, g = _inputs(b, hq, hkv, sq, skv, d, dv, seed=1)

    def f(a, b_, c):
        o = jfa.fused_attention(a, b_, c, causal, None, q_offset, 64, 64,
                                True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fused_attention(*leaves, causal=causal, q_offset=q_offset)
    out.backward(torch.from_numpy(g))
    for t, w in zip(leaves, want):
        _close(t.grad, w, 2e-4)


@pytest.mark.parametrize("rope", [1e4, None], ids=["rope", "norope"])
def test_fused_qproj_attention_forward_and_grads_match_jax(rope):
    rng = np.random.default_rng(2)
    b, sq, e, hq, hkv, d, skv = 2, 96, 48, 6, 2, 32, 128
    x, wq = _rand(rng, b, sq, e), _rand(rng, e, hq, d, scale=e ** -0.5)
    k, v = _rand(rng, b, hkv, skv, d), _rand(rng, b, hkv, skv, d)
    g = _rand(rng, b, hq, sq, d)
    jargs = [jnp.asarray(a) for a in (x, wq, k, v)]

    def f(*a):
        o = jfqa.fused_qproj_attention(*a, True, None, None, rope, 64, 64,
                                       True)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, jo), want = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                       has_aux=True)(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wq, k, v)]
    out = fused_qproj_attention(*leaves, rope_theta=rope)
    _close(out, jo, 2e-5)
    out.backward(torch.from_numpy(g))
    for t, w in zip(leaves, want):
        _close(t.grad, w, 2e-4)
    # the forward wrapper (#10) returns the forward's lse too
    o, lse = fused_qproj_attention_fwd(*(t.detach() for t in leaves),
                                       rope_theta=rope)
    _, jlse = jfqa._qproj_fwd(*jargs, causal=True, scale=d ** -0.5,
                              q_offset=None, rope_theta=rope, block_q=64,
                              block_k=64, interpret=True)
    _close(lse, jlse, 1e-5)


def test_ops_cache_free_call_is_the_training_attention():
    """A cache-free call takes the differentiable ``fused_attention``:
    counted ``("attention", "torch")`` on the CPU, equal to the plain
    forward, with gradients, and no kernel launched."""
    q, k, v, _ = _inputs(2, 6, 2, 40, 40, 32, 32, seed=3)
    tq = torch.from_numpy(q).requires_grad_()
    ops.reset_counts()
    out = ops.attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert ops.CALLS[("attention", "torch")] == 1
    want, _ = ref.attention_fwd_plain(tq.detach(), torch.from_numpy(k),
                                      torch.from_numpy(v))
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert tq.grad is not None and tq.grad.abs().max() > 0
    assert not build.LAUNCHES


def test_ops_explicit_offset_is_no_longer_downgraded():
    """A cache-free causal call whose q_offset is not Skv - Sq runs the
    training attention at that offset, as the JAX package runs
    ``fused_attention``: no warning, no downgrade on the plan."""
    from repro_torch import configs, lower
    cfg = configs.get_config("qwen3-8b", smoke=True)
    d = lower.serving_plan(cfg, 256, device="cpu").prefill_dispatch(200)
    q, k, v, _ = _inputs(2, 4, 2, 24, 64, 32, 32, seed=4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ops.reset_counts()
    ops.reset_downgrade_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ops.attention(tq, tk, tv, q_offset=17, plan=d)
    want, _ = ref.attention_fwd_plain(tq, tk, tv, q_offset=17)
    assert torch.equal(got, want)
    assert not d.plan.downgrades
    assert ops.CALLS[("attention", d.impl)] == 1


def test_ops_qproj_without_lengths_runs_the_training_schedule():
    rng = np.random.default_rng(5)
    x, wq = _rand(rng, 2, 40, 48), _rand(rng, 48, 6, 32, scale=48 ** -0.5)
    k, v = _rand(rng, 2, 2, 40, 32), _rand(rng, 2, 2, 40, 32)
    tx = torch.from_numpy(x).requires_grad_()
    args = (torch.from_numpy(wq), torch.from_numpy(k), torch.from_numpy(v))
    ops.reset_counts()
    got = ops.qproj_attention(tx, *args, rope_theta=1e4)
    assert ops.CALLS[("qproj_attention", "torch")] == 1
    ref_out = ops.qproj_attention(tx.detach(), *args, rope_theta=1e4,
                                  impl="reference")
    torch.testing.assert_close(got.detach(), ref_out, rtol=0, atol=1e-5)
    got.sum().backward()
    assert tx.grad is not None and tx.grad.abs().max() > 0


def test_kernel_wrappers_refuse_a_tensor_that_requires_grad():
    """A kernel without a backward never returns a result cut from
    autograd: the wrappers' shared check raises on an input that
    requires grad (before any device check), and passes it under
    no_grad, where the device check then refuses the CPU tensor."""
    q = torch.zeros(1, 2, 1, 8, requires_grad=True)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="require grad"):
        check_cuda_args("fused_attention_masked", {"q": q}, lens, (8,))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        check_cuda_args("fused_attention_masked", {"q": q}, lens, (8,))
