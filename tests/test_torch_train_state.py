"""The port's training state against the JAX package's: AdamW, the
cosine schedule and int8 compression on the same numpy gradients
(within 1e-6; kept apart from the gradient test, since AdamW's first
step is about lr * sign(g) and would hide what differs), the token data
bit for bit, and the checkpoint manager: round trip (bf16 leaves
included), retention, its errors, the restart harness, and a crash,
restore and resume bitwise equal to an uninterrupted run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticTokenDataset as JaxSynthetic
from repro.data import make_batch_iterator as jax_batches
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.data import (MemmapTokenDataset, SyntheticTokenDataset,
                              make_batch_iterator)
from repro_torch.models.weights import adamw_state_from_numpy
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, int8_compress_with_feedback)
from repro_torch.runtime import StepTimer, run_with_restarts
from repro_torch.train.step import init_train_state, train_step

torch.set_num_threads(2)

CFG = configs.get_config("qwen3-8b", smoke=True)


def _np_tree(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"a": (4, 8), "b": {"c": (3, 5, 7)}, "d": [(6,)]}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _torch(t, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), t)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    params = _np_tree(0)
    sched = jax_adamw.cosine_schedule(1e-2, warmup_steps=1, total_steps=4)
    jp, jstate = jax.tree.map(jnp.asarray, params), \
        jax_adamw.adamw_init(jax.tree.map(jnp.asarray, params),
                             moment_dtype)
    tp = _torch(params)
    tstate = adamw_init(tp, moment_dtype)
    port_sched = cosine_schedule(1e-2, warmup_steps=1, total_steps=4)
    for step in range(3):
        # the second step's gradients exceed the clip norm of 1
        grads = jax.tree.map(lambda a: a * (5.0 if step == 1 else 0.1),
                             _np_tree(10 + step))
        jp, jstate, jm = jax_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate, lr=sched)
        tp, tstate, tm = adamw_update(tp, _torch(grads), tstate,
                                      lr=port_sched)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for j, t in zip(jax.tree.leaves((jp, jstate.mu, jstate.nu)),
                        tree.leaves((tp, tstate.mu, tstate.nu))):
            assert str(t.dtype).endswith(str(j.dtype))
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), rtol=0,
                                       atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    # the state crosses over from the JAX package too
    back = adamw_state_from_numpy(np.asarray(jstate.step),
                                  jax.tree.map(np.asarray, jstate.mu),
                                  jax.tree.map(np.asarray, jstate.nu), CFG,
                                  device="cpu")
    assert int(back.step) == 3
    for a, b in zip(tree.leaves(back.mu), tree.leaves(tstate.mu)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-6)


def test_large_leaves_update_in_chunks_as_a_whole():
    """A leaf over the chunk size is updated a slice at a time; the
    result is the one-piece update's."""
    from repro_torch.optim import adamw as port_adamw
    params = _np_tree(1, {"w": (6, 50, 40)})
    grads = _np_tree(2, {"w": (6, 50, 40)})
    outs = []
    for chunk in (port_adamw.CHUNK, 4000):
        old, port_adamw.CHUNK = port_adamw.CHUNK, chunk
        try:
            tp = _torch(params)
            outs.append(adamw_update(tp, _torch(grads), adamw_init(tp),
                                     lr=1e-2)[0]["w"])
        finally:
            port_adamw.CHUNK = old
    assert len(port_adamw.chunks(torch.zeros(6, 50, 40))) == 1
    assert torch.equal(outs[0], outs[1])


def test_clip_and_schedule_match_jax():
    g = _np_tree(3)
    jclipped, jn = jax_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    clipped, n = clip_by_global_norm(_torch(g), 1.0)
    assert float(n) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree.leaves(jclipped), tree.leaves(clipped)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    js = jax_adamw.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    ps = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        assert float(ps(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(js(jnp.asarray(s))), rel=1e-6, abs=1e-12)


def test_int8_compression_with_feedback_matches_jax():
    g0 = _np_tree(4)
    jfb = jax_comp.error_feedback_init(jax.tree.map(jnp.asarray, g0))
    tfb = tree.map(lambda t: torch.zeros_like(t), _torch(g0))
    for step in range(3):
        g = _np_tree(20 + step)
        jsent, jfb = jax_comp.int8_compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jfb)
        tsent, tfb = int8_compress_with_feedback(_torch(g), tfb)
        for a, b in zip(jax.tree.leaves((jsent, jfb)),
                        tree.leaves((tsent, tfb))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("structured", [False, True])
def test_token_data_is_the_jax_packages(structured):
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=3,
              structured=structured)
    port, ref = SyntheticTokenDataset(**kw), JaxSynthetic(**kw)
    for step in (0, 5, 1234):
        np.testing.assert_array_equal(port.batch(step), ref.batch(step))
    np.testing.assert_array_equal(port.batch(5, row_start=2, rows=2),
                                  port.batch(5)[2:4])
    it = make_batch_iterator(port, start_step=5, n_hosts=2, host_id=1)
    jit_ = jax_batches(ref, start_step=5, n_hosts=2, host_id=1)
    for _ in range(3):
        (s1, r1), (s2, r2) = next(it), next(jit_)
        assert s1 == s2
        np.testing.assert_array_equal(r1, r2)
    it.close()
    jit_.close()
    assert it.state_dict(7) == {"step": 8}


def test_memmap_dataset_strides_deterministically(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    ds = MemmapTokenDataset(str(path), vocab_size=97, seq_len=9,
                            global_batch=4)
    b = ds.batch(2)
    assert b.shape == (4, 10)
    np.testing.assert_array_equal(b[0], np.arange(80, 90) % 97)


def _state_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "h": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    t = _state_tree()
    mgr.save(3, t, extras={"next_step": 4}, blocking=True)
    restored, extras = mgr.restore(_state_tree(1))
    assert extras == {"next_step": 4}
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for s in range(4, 8):
        mgr.save(s, _state_tree(s))
    mgr.wait()
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    leaves, extras = mgr.restore_flat()
    assert extras == {} and len(leaves) == 4
    assert torch.equal(leaves[2], _state_tree(7)["b"]["h"])


def test_checkpoint_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(_state_tree())
    mgr.save(1, _state_tree(), blocking=True)
    with pytest.raises(CheckpointError, match="step 7 missing"):
        mgr.restore(_state_tree(), step=7)
    with pytest.raises(CheckpointError, match="structure mismatch"):
        mgr.restore({"a": torch.zeros(4, 8)})
    leaf = os.path.join(tmp_path, "step_000000001", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) // 2)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        mgr.restore(_state_tree())
    os.remove(leaf)
    with pytest.raises(CheckpointError, match="missing"):
        mgr.restore(_state_tree())
    man = os.path.join(tmp_path, "step_000000001", "manifest.json")
    with open(man, "w") as f:
        f.write('{"step": 1, "leaves": [truncated')
    with pytest.raises(CheckpointError, match="manifest.json corrupt"):
        mgr.restore(_state_tree())


def test_run_with_restarts_identical_to_uninterrupted(tmp_path):
    def make_state():
        return {"x": torch.zeros(())}

    def clean_step(state, step):
        return {"x": state["x"] * 1.01 + step}

    s = make_state()
    for i in range(20):
        s = clean_step(s, i)
    crashes = {7: True, 13: True}

    def make_step():
        def step(state, i):
            if crashes.pop(i, False):
                raise RuntimeError("injected node failure")
            return clean_step(state, i)
        return step

    ckpt = CheckpointManager(str(tmp_path), keep_last=5)
    final, stats = run_with_restarts(make_step, make_state, ckpt,
                                     total_steps=20, checkpoint_every=5)
    assert stats["restarts"] == 2
    assert torch.equal(final["x"], s["x"])


def test_step_timer_flags_stragglers():
    import time
    t = StepTimer(k=3.0)
    for _ in range(6):
        t.start()
        time.sleep(0.002)
        assert not t.stop()
    t.start()
    time.sleep(0.05)
    assert t.stop()
    assert t.median > 0 and StepTimer().median == 0.0


def test_crash_restore_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """After ``tests/test_system.py``: 8 steps uninterrupted against 4
    steps, a checkpoint, a "crash", a restore into a fresh state and 4
    more steps; parameters, moments and step equal bit for bit."""
    ds = SyntheticTokenDataset(CFG.vocab_size, 24, 4, seed=1)

    def fresh():
        g = torch.Generator().manual_seed(0)
        return init_train_state(g, CFG, device="cpu")

    def run(state, start, stop):
        for step in range(start, stop):
            batch = {"tokens": torch.from_numpy(ds.batch(step)).long()}
            state, _ = train_step(state, batch, CFG, lr=1e-3)
        return state

    ref = run(fresh(), 0, 8)
    ckpt = CheckpointManager(str(tmp_path))
    st = run(fresh(), 0, 4)
    ckpt.save(3, st, extras={"next_step": 4}, blocking=True)
    del st
    restored, extras = ckpt.restore(fresh())
    out = run(restored, extras["next_step"], 8)
    for a, b in zip(tree.leaves(ref), tree.leaves(out)):
        assert torch.equal(a, b)
