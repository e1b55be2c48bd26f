"""The chaos suite of the JAX package (``tests/test_chaos.py``) run
through the port's supervisor, on the CPU, against the JAX supervisor
on the same weights (qwen3-8b smoke, fp32, shared through
``params_from_numpy``).

Every fixed schedule of the JAX suite (all fault kinds on the paged
engine, the dense engine, the seeded schedule at seeds 0 and 1, a retry
budget spent) runs once through each package, with the audit on every
step (``audit_every=1`` raises on a violation).  The port must give the
JAX run's tokens, fired log and ledger JSON, string for string, and the
fault-free run's tokens.  At these contexts (below the crossover 2N =
64) the plan resolves the unfused ``reference`` impl in both packages,
so kernel faults name it; the rung below is the JAX package's
``unfused/xla`` and the port's ``unfused/torch``, which the ledgers do
not name.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as jax_configs
from repro.models import init_params_and_axes

import repro_torch.serve as P
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.weights import params_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_injector_left():
    """``tests/conftest.py`` clears only the JAX package's hook."""
    ops.set_fault_injector(None)
    yield
    ops.set_fault_injector(None)


@pytest.fixture(scope="module")
def qwen():
    """{"jax": (cfg, params), "torch": (cfg, params on the CPU)}."""
    jcfg = jax_configs.get_config("qwen3-8b", smoke=True)   # 2N = 64
    jparams, _ = init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config("qwen3-8b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return {"jax": (jcfg, jparams), "torch": (cfg, params)}


SIDES = {"jax": (J, {}), "torch": (P, {"device": "cpu"})}


def _prompt(vocab, key, n):
    return [int(t) for t in jax.random.randint(
        jax.random.PRNGKey(key), (n,), 0, vocab)]


def _stack(qwen, side, paged=True, num_pages=13):
    """The JAX suite's engines: batch 4, max_len 64, chunk 16, pages of
    8 (a pool of 13 that runs short under the suite's five requests)."""
    mod, kw = SIDES[side]
    cfg, params = qwen[side]
    if paged:
        plan = mod.make_serving_plan(cfg, 64, paged=True, page_size=8, **kw)
        eng = mod.PagedContinuousBatchingEngine(
            params, cfg, batch_size=4, max_len=64, page_size=8,
            num_pages=num_pages, plan=plan, prefill_chunk=16, **kw)
    else:
        plan = mod.make_serving_plan(cfg, 64, **kw)
        eng = mod.ContinuousBatchingEngine(params, cfg, batch_size=4,
                                           max_len=64, plan=plan,
                                           prefill_chunk=16, **kw)
    return eng, mod.RequestBatcher(batch_size=4, eos_id=-1, max_len=64)


def _run(qwen, side, schedule=None, *, paged=True, n=5, budget=6,
         seeded=None, max_steps=80, **sup_kw):
    """One supervised run of the suite's ``n`` requests.  ``schedule``:
    FaultSpec fields per spec; ``seeded``: ``from_seed`` arguments.
    Returns a dict of what the tests compare."""
    mod, _ = SIDES[side]
    eng, bat = _stack(qwen, side, paged)
    for u in range(n):
        bat.submit(mod.Request(uid=u, prompt=_prompt(
            qwen[side][0].vocab_size, u, 5 + 3 * u), max_new_tokens=budget))
    inj = None
    if seeded is not None:
        inj = mod.FaultInjector.from_seed(**seeded)
    elif schedule is not None:
        inj = mod.FaultInjector([mod.FaultSpec(**s) for s in schedule])
    sup = mod.ServingSupervisor(eng, bat, injector=inj, **sup_kw)
    fin = sup.serve(max_steps=max_steps)
    return {"tokens": {r.uid: list(r.generated) for r in fin},
            "fired": None if inj is None else inj.fired,
            "ledger": sup.ledger.to_json(),
            "failed": [r.uid for r in sup.failed],
            "audit": mod.audit_engine(eng, bat),
            "eng": eng, "sup": sup}


def _same(got, want):
    for key in ("tokens", "fired", "ledger", "failed", "audit"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def paged_baseline(qwen):
    """The fault-free supervised paged run, JAX's tokens: the parity
    reference of every paged schedule."""
    want = _run(qwen, "jax", audit_every=1)
    assert not want["failed"] and len(want["tokens"]) == 5
    return want["tokens"]


def test_fault_free_supervised_matches_jax_and_the_batcher(qwen,
                                                           paged_baseline):
    got = _run(qwen, "torch", audit_every=1)
    assert got["tokens"] == paged_baseline and got["ledger"] == "[]"
    eng, bat = _stack(qwen, "torch")
    for u in range(5):
        bat.submit(P.Request(uid=u, prompt=_prompt(
            qwen["torch"][0].vocab_size, u, 5 + 3 * u), max_new_tokens=6))
    assert {r.uid: r.generated for r in bat.serve(eng)} == paged_baseline


ALL_KINDS = [dict(kind="nan", step=1, slot=1),
             dict(kind="oom", step=2, times=1),
             dict(kind="kernel", step=3, impl="reference", times=None),
             dict(kind="nan", step=4, slot=2),
             dict(kind="preempt", step=5, count=2)]


def test_paged_all_fault_kinds_match_jax(qwen, paged_baseline):
    """Injected OOM, a persistent sick kernel, two NaN poisonings and a
    preemption storm on the paged engine: JAX's tokens, fired log and
    ledger, the fault-free tokens, a clean audit every step, the
    rung-down on the plan's ledger and the demotion decayed to 0."""
    want = _run(qwen, "jax", ALL_KINDS, cooloff=2, audit_every=1)
    got = _run(qwen, "torch", ALL_KINDS, cooloff=2, audit_every=1)
    _same(got, want)
    assert got["tokens"] == paged_baseline and not got["failed"]
    assert {f[1] for f in got["fired"]} == {"oom", "kernel", "nan",
                                            "preempt"}
    counts = got["sup"].ledger.counts()
    assert all(counts.get(k, 0) > 0 for k in ("oom", "kernel", "nan",
                                              "preempt", "cooloff"))
    eng = got["eng"]
    assert any("kernel-failure recovery" in dg.reason
               for dg in eng.last_dispatch.plan.downgrades)
    assert eng.demotions == 0 and got["audit"] == []


def test_dense_chaos_matches_jax(qwen):
    """The dense engine through the same supervisor: NaN quarantine by
    dense preempt/resume, a storm and a sick kernel."""
    sched = [dict(kind="nan", step=2, slot=0),
             dict(kind="kernel", step=3, impl="reference", times=1),
             dict(kind="preempt", step=4, count=1)]
    base = _run(qwen, "torch", None, paged=False, n=4, max_steps=60)
    want = _run(qwen, "jax", sched, paged=False, n=4)
    got = _run(qwen, "torch", sched, paged=False, n=4, audit_every=1)
    _same(got, want)
    assert got["tokens"] == base["tokens"] \
        == _run(qwen, "jax", None, paged=False, n=4, max_steps=60)["tokens"]
    assert {f[1] for f in got["fired"]} == {"nan", "kernel", "preempt"}


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_ledger_matches_jax(qwen, paged_baseline, seed):
    """The seeded schedule (the JAX suite's CHAOS_SEED gate, at both
    seeds): two port runs give the same ledger and fired log, JAX's,
    and the fault-free tokens."""
    seeded = dict(seed=seed, steps=10, slots=4, rate=0.5, impl="reference")
    kw = dict(seeded=seeded, retry_budget=8, audit_every=1, max_steps=120)
    want = _run(qwen, "jax", **kw)
    a, b = _run(qwen, "torch", **kw), _run(qwen, "torch", **kw)
    _same(a, b)
    _same(a, want)
    assert a["fired"] and not a["failed"]
    assert a["tokens"] == paged_baseline


def test_nan_retry_budget_exhaustion_matches_jax(qwen, paged_baseline):
    """A slot poisoned past its retry budget fails its request visibly
    (ledger row, ``failed``), as in JAX; the others keep parity."""
    sched = [dict(kind="nan", step=t, slot=0) for t in range(1, 6)]
    kw = dict(n=4, retry_budget=1, audit_every=1)
    want = _run(qwen, "jax", sched, **kw)
    got = _run(qwen, "torch", sched, **kw)
    _same(got, want)
    assert got["failed"] == [0]
    req = got["sup"].failed[0]
    assert req.failed and req.done
    assert any(i.outcome == "failed (retry budget exhausted)"
               for i in got["sup"].ledger.incidents)
    assert set(got["tokens"]) == {1, 2, 3}
    assert all(got["tokens"][u] == paged_baseline[u] for u in got["tokens"])
