"""Crash-safe serving snapshots of the port, on the CPU.

* The JAX suite's crash test (``tests/test_chaos.py::
  test_crash_snapshot_restore_bit_identical``): snapshot every 3 steps,
  crash after 7, restore the latest snapshot into a fresh engine,
  batcher and supervisor, finish; the tokens equal the uncrashed run's,
  which are the JAX supervisor's on the same weights (qwen3-8b smoke,
  fp32).
* The same crash and restore on mamba2-130m smoke through the dense
  engine (no plan: Mamba-2 blocks are no DSE workload): the conv tails
  and SSM states come back from the snapshot, the audit is clean and
  the tokens equal the JAX supervisor's uncrashed run.
* A round trip whose checkpoint holds an in-flight prefill and a paused
  request, dense and paged: every tensor of the restored engine, its
  pending side cache and the paused KV snapshot equal the live ones bit
  for bit, the host mirrors and the scheduler too, and both then serve
  the same tokens and ledger.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as jax_configs
from repro.models import init_params_and_axes

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine, FaultInjector,
                               FaultSpec, PagedContinuousBatchingEngine,
                               Request, RequestBatcher, ServingSupervisor,
                               audit_engine, make_serving_plan)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_injector_left():
    """``tests/conftest.py`` clears only the JAX package's hook."""
    ops.set_fault_injector(None)
    yield
    ops.set_fault_injector(None)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_configs.get_config("qwen3-8b", smoke=True)
    jparams, _ = init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config("qwen3-8b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(vocab, n=5):
    return [[int(t) for t in jax.random.randint(
        jax.random.PRNGKey(u), (5 + 3 * u,), 0, vocab)] for u in range(n)]


def _stack(cfg, params, paged=True, chunk=16, num_pages=13):
    if paged:
        plan = make_serving_plan(cfg, 64, device="cpu", paged=True,
                                 page_size=8)
        eng = PagedContinuousBatchingEngine(
            params, cfg, batch_size=4, max_len=64, page_size=8,
            num_pages=num_pages, plan=plan, prefill_chunk=chunk,
            device="cpu")
    else:
        eng = ContinuousBatchingEngine(
            params, cfg, batch_size=4, max_len=64,
            plan=make_serving_plan(cfg, 64, device="cpu"),
            prefill_chunk=chunk, device="cpu")
    return eng, RequestBatcher(batch_size=4, eos_id=-1, max_len=64)


def _tokens(finished):
    return {r.uid: list(r.generated) for r in finished}


def test_crash_snapshot_restore_matches_the_uncrashed_run(qwen, tmp_path):
    jcfg, jparams, cfg, params = qwen
    prompts = _prompts(cfg.vocab_size)
    jeng = J.PagedContinuousBatchingEngine(
        jparams, jcfg, batch_size=4, max_len=64, page_size=8, num_pages=13,
        plan=J.make_serving_plan(jcfg, 64, paged=True, page_size=8),
        prefill_chunk=16)
    jbat = J.RequestBatcher(batch_size=4, eos_id=-1, max_len=64)
    for u, p in enumerate(prompts):
        jbat.submit(J.Request(uid=u, prompt=p, max_new_tokens=6))
    want = _tokens(J.ServingSupervisor(jeng, jbat).serve(max_steps=60))

    eng, bat = _stack(cfg, params)
    for u, p in enumerate(prompts):
        bat.submit(Request(uid=u, prompt=p, max_new_tokens=6))
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    sup = ServingSupervisor(eng, bat, ckpt=mgr, checkpoint_every=3,
                            audit_every=1)
    for _ in range(7):                     # checkpoints land at t=3, 6
        assert bat.active or eng._pending
        sup.step()
    assert mgr.latest_step() == 6
    del sup, eng, bat                      # the crash

    eng2, bat2 = _stack(cfg, params)       # nothing submitted: restore
    sup2 = ServingSupervisor(eng2, bat2,   # owns the queue wholesale
                             ckpt=CheckpointManager(str(tmp_path)),
                             audit_every=1)
    sup2.restore()
    assert sup2.t == 6 and audit_engine(eng2, bat2) == []
    fin = sup2.serve(max_steps=80)
    assert not sup2.failed
    assert _tokens(fin) == want


def test_mamba2_crash_snapshot_restore_matches_the_uncrashed_run(tmp_path):
    jcfg = jax_configs.get_config("mamba2-130m", smoke=True)
    jparams, _ = init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config("mamba2-130m", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    prompts = _prompts(cfg.vocab_size)
    assert J.make_serving_plan(jcfg, 64) is None
    jeng = J.ContinuousBatchingEngine(jparams, jcfg, batch_size=4,
                                      max_len=64, prefill_chunk=16)
    jbat = J.RequestBatcher(batch_size=4, eos_id=-1, max_len=64)
    for u, p in enumerate(prompts):
        jbat.submit(J.Request(uid=u, prompt=p, max_new_tokens=6))
    want = _tokens(J.ServingSupervisor(jeng, jbat).serve(max_steps=60))

    def stack():
        assert make_serving_plan(cfg, 64, device="cpu") is None
        return (ContinuousBatchingEngine(params, cfg, batch_size=4,
                                         max_len=64, prefill_chunk=16,
                                         device="cpu"),
                RequestBatcher(batch_size=4, eos_id=-1, max_len=64))

    eng, bat = stack()
    for u, p in enumerate(prompts):
        bat.submit(Request(uid=u, prompt=p, max_new_tokens=6))
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    sup = ServingSupervisor(eng, bat, ckpt=mgr, checkpoint_every=3,
                            audit_every=1)
    for _ in range(7):                     # checkpoints land at t=3, 6
        assert bat.active or eng._pending
        sup.step()
    assert mgr.latest_step() == 6
    del sup, eng, bat                      # the crash

    eng2, bat2 = stack()
    sup2 = ServingSupervisor(eng2, bat2,
                             ckpt=CheckpointManager(str(tmp_path)),
                             audit_every=1)
    sup2.restore()
    assert sup2.t == 6 and audit_engine(eng2, bat2) == []
    fin = sup2.serve(max_steps=80)
    assert not sup2.failed
    assert _tokens(fin) == want
    assert all(len(t) == 6 for t in want.values())


def _equal_trees(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def _req(r):
    return (r.uid, r.prompt, r.generated, r.max_new_tokens, r.retries,
            r.failed, r.done)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_round_trip_with_a_pending_prefill_and_a_paused_request(
        qwen, tmp_path, paged):
    """Chunks of 8 keep the 30- and 40-token prompts in flight at the
    snapshot (end of step 2), and a storm at step 2 leaves the newest
    live lease preempted on the queue front with its KV on
    ``paused``."""
    cfg, params = qwen[2], qwen[3]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 30, 9, 40)]
    runs = []
    for _ in range(2):
        eng, bat = _stack(cfg, params, paged, chunk=8, num_pages=24)
        for u, p in enumerate(prompts):
            bat.submit(Request(uid=u, prompt=p, max_new_tokens=6))
        inj = FaultInjector([FaultSpec("preempt", step=2, count=1)])
        sup = ServingSupervisor(eng, bat, injector=inj, cooloff=2,
                                ckpt=CheckpointManager(
                                    str(tmp_path / f"run{len(runs)}")),
                                checkpoint_every=3, audit_every=1)
        sup._attach()
        try:
            for _ in range(3):
                sup.step()
        finally:
            sup._detach()
        runs.append((eng, bat, sup))
    eng, bat, sup = runs[0]
    assert sorted(eng._pending) == [1, 3]
    assert [r.paused is not None for r in bat.queue] == [True]
    assert sup.ckpt.latest_step() == 3

    eng2, bat2 = _stack(cfg, params, paged, chunk=8, num_pages=24)
    sup2 = ServingSupervisor(eng2, bat2, ckpt=sup.ckpt, cooloff=2,
                             audit_every=1)
    sup2.restore()
    _equal_trees(eng2.state, eng.state)
    assert (eng2.row_ctx, eng2.live) == (eng.row_ctx, eng.live)
    assert eng2._pending.keys() == eng._pending.keys()
    for slot, p in eng._pending.items():
        q = eng2._pending[slot]
        assert q["pos"] == p["pos"] and torch.equal(q["tokens"], p["tokens"])
        _equal_trees(q["cache"], p["cache"])
    assert [_req(r) for r in bat2.queue] == [_req(r) for r in bat.queue]
    for r, r2 in zip(bat.queue, bat2.queue):
        assert (r.paused is None) == (r2.paused is None)
        if r.paused is not None:
            _equal_trees(r2.paused.kv, r.paused.kv)
            assert (r2.paused.n_pages, r2.paused.length,
                    r2.paused.last_token) == (r.paused.n_pages,
                                              r.paused.length,
                                              r.paused.last_token)
    assert [r and _req(r) for r in bat2.slots] == \
        [r and _req(r) for r in bat.slots]
    assert bat2.slot_lens == bat.slot_lens
    assert sup2.state_dict() == sup.state_dict()
    if paged:
        a, a2 = eng.allocator, eng2.allocator
        assert (a2._free, a2.pages, a2.peak_used) == \
            (a._free, a.pages, a.peak_used)
        assert (eng2.lease_order, eng2._lease_clock, eng2._table_pages) \
            == (eng.lease_order, eng._lease_clock, eng._table_pages)

    # the uncrashed twin and the restored engine finish alike
    twin = runs[1][2]
    want = _tokens(twin.serve(max_steps=80))
    assert _tokens(sup2.serve(max_steps=80)) == want
    # the ledger is not part of a snapshot: the restored run's rows are
    # the twin's after the snapshot step
    assert sup2.ledger.rows() == twin.ledger.rows()[len(sup.ledger):]
