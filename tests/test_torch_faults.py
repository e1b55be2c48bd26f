"""The port's fault-injection layer against the JAX package's, on the
CPU (the fast tier: one small engine, no JAX engine run).

* ``FaultSpec`` validation, the kinds, ``from_seed``'s schedules (the
  JAX package's for the same seed), the fired log of a replayed
  consultation pattern (the JAX injector's), the ``times`` budget, and
  the ledger that leaves timing kinds out (the JAX ledger's JSON).
* ``on_kernel`` through the port's ``kernels.ops``: every attention
  entry point, dense and paged, consults the injector once its impl is
  resolved, under the plain entry name, as the JAX ``ops`` does; a call
  that raises is not counted; ``ssd`` is never consulted; the
  supervisor catches no failure of a kernel's own (a launch error, a
  build failure, a refused shape).
* The auditor catches each seeded corruption of the JAX suite
  (``tests/test_chaos.py::test_audit_detects_seeded_corruption``) on the
  port's paged engine, and audits clean once it is repaired.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve import faults as jfaults

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.models.weights import init_params
from repro_torch.serve import (FaultInjector, FaultSpec, IncidentLedger,
                               OutOfPages, PagedContinuousBatchingEngine,
                               Request, RequestBatcher, ServingSupervisor,
                               audit_engine, make_serving_plan)
from repro_torch.serve import faults

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_injector_left():
    """``tests/conftest.py`` clears only the JAX package's hook."""
    ops.set_fault_injector(None)
    yield
    ops.set_fault_injector(None)


def _fields(schedule):
    return [dataclasses.asdict(s) for s in schedule]


def test_fault_spec_rejects_unknown_kind_and_keeps_the_kinds():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(kind="gremlin", step=0)
    assert faults.KINDS == jfaults.KINDS
    assert faults.TIMING_KINDS == jfaults.TIMING_KINDS
    assert FaultSpec("kernel", step=0).impl == "cuda"
    assert FaultInjector.from_seed(3, steps=40, slots=4,
                                   rate=0.5).schedule[0].impl == "cuda"


def _replay(inj, impl):
    """The JAX suite's consultation pattern over 24 steps."""
    for t in range(24):
        inj.begin_step(t)
        try:
            inj.on_alloc(0, 1)
        except (OutOfPages, jfaults.OutOfPages):
            pass
        try:
            inj.on_kernel("attention", impl)
        except (KernelLaunchError, jops.KernelLaunchError):
            pass
        inj.nan_slot()
        inj.preempt_storm()
    return inj.fired


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_schedules_and_fired_logs_match_jax(seed):
    """Same seed: the same schedule and the same fired log run after
    run, and the JAX injector's (spec for spec, impl aside); another
    seed, another schedule."""
    mk = lambda s: FaultInjector.from_seed(s, steps=24, slots=4, rate=0.4,
                                           impl="reference")
    a, b = mk(seed), mk(seed)
    want = jfaults.FaultInjector.from_seed(seed, steps=24, slots=4,
                                           rate=0.4, impl="reference")
    assert a.schedule and _fields(a.schedule) == _fields(b.schedule) \
        == _fields(want.schedule)
    assert _replay(a, "reference") == _replay(b, "reference") \
        == _replay(want, "reference")
    assert _fields(mk(seed + 1).schedule) != _fields(a.schedule)


def test_fault_spec_times_budget():
    """times=1 fails once and lets the retry through; times=None fires
    on every consultation of its step; both re-arm on begin_step."""
    inj = FaultInjector([FaultSpec("oom", step=0, times=1),
                         FaultSpec("nan", step=1, slot=2, times=None),
                         FaultSpec("kernel", step=2, impl="torch",
                                   times=2)])
    inj.begin_step(0)
    with pytest.raises(OutOfPages, match="injected page exhaustion"):
        inj.on_alloc("k", 2)
    inj.on_alloc("k", 2)
    inj.begin_step(1)
    assert inj.nan_slot() == 2 and inj.nan_slot() == 2
    inj.begin_step(2)
    assert inj.nan_slot() is None
    inj.on_kernel("attention", "cuda")          # another impl: no fault
    for _ in range(2):
        with pytest.raises(KernelLaunchError, match="impl='torch'"):
            inj.on_kernel("attention", "torch")
    inj.on_kernel("attention", "torch")
    inj.begin_step(0)
    with pytest.raises(OutOfPages):
        inj.on_alloc("k", 2)
    assert [f[1] for f in inj.fired] == ["oom", "nan", "nan", "kernel",
                                         "kernel", "oom"]


def test_incident_ledger_excludes_timing_as_jax():
    led, want = IncidentLedger(), jfaults.IncidentLedger()
    for ledger in (led, want):
        ledger.record(3, 1, "nan", "quarantine", "requeued", "request 2")
        ledger.record(4, None, "stuck_step", "watchdog", "noted")
    assert led.counts() == {"nan": 1, "stuck_step": 1}
    assert [r["fault"] for r in led.rows()] == ["nan"]
    assert "stuck_step" not in led.to_json()
    assert "stuck_step" in led.to_json(include_timing=True)
    assert len(led) == 2
    assert led.to_json() == want.to_json()
    assert led.to_json(include_timing=True) == \
        want.to_json(include_timing=True)


# ---------------------------------------------------------------------------
# on_kernel at the port's dispatch
# ---------------------------------------------------------------------------

B, HQ, HKV, D, E, PAGE, PAGES = 2, 4, 2, 16, 32, 8, 4


def _operands(paged: bool):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)
    x, res = rnd(B, 1, E), rnd(B, 1, E)
    wq, wo = rnd(E, HQ, D) * E ** -0.5, rnd(HQ, D, E) * 0.1
    q = rnd(B, HQ, 1, D)
    lens = torch.tensor([5, 11], dtype=torch.int32)
    if paged:
        k, v = rnd(1 + B * PAGES, HKV, PAGE, D), rnd(1 + B * PAGES, HKV,
                                                      PAGE, D)
        tables = torch.arange(1, 1 + B * PAGES,
                              dtype=torch.int32).reshape(B, PAGES)
    else:
        k, v = rnd(B, HKV, PAGE * PAGES, D), rnd(B, HKV, PAGE * PAGES, D)
        tables = None
    return {
        "attention": lambda impl: ops.attention(
            q, k, v, lengths=lens, block_tables=tables, impl=impl),
        "qproj_attention": lambda impl: ops.qproj_attention(
            x, wq, k, v, lengths=lens, block_tables=tables,
            rope_theta=1e4, impl=impl),
        "decode_block": lambda impl: ops.decode_block(
            x, wq, k, v, wo, res, lens, block_tables=tables,
            rope_theta=1e4, impl=impl),
    }


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("entry", ["attention", "qproj_attention",
                                   "decode_block"])
def test_on_kernel_fires_at_each_attention_entry(entry, paged):
    """The injector sees (entry, resolved impl), the plain entry name
    for a paged call; a matching spec raises the port's
    KernelLaunchError before the call is counted; another impl passes
    and is counted."""
    call = _operands(paged)[entry]
    counted = f"{entry}_paged" if paged else entry
    inj = FaultInjector([FaultSpec("kernel", step=0, impl="torch",
                                   times=1)])
    inj.begin_step(0)
    ops.set_fault_injector(inj)
    ops.reset_counts()
    call("reference")
    with pytest.raises(KernelLaunchError) as err:
        call("torch")
    assert isinstance(err.value, RuntimeError)
    assert str(err.value) == (f"injected kernel launch failure at step 0 "
                              f"({entry}, impl='torch')")
    assert inj.fired == [(0, "kernel", f"{entry}/torch")]
    assert ops.CALLS == {(counted, "reference"): 1}
    out = call("torch")                       # the budget is spent
    assert torch.isfinite(out).all()
    assert ops.CALLS[(counted, "torch")] == 1


def test_on_kernel_names_and_messages_match_jax():
    """The JAX ``ops.attention`` and the port's, each with its own
    injector armed for the ``reference`` impl: the same fired log and
    the same message."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, HQ, 1, D), (B, HKV, 32, D), (B, HKV, 32, D)))
    lens = np.array([5, 11], np.int32)
    got, want = [], []
    for mod, fmod, call, out in (
            (ops, faults, lambda: ops.attention(
                *map(torch.from_numpy, (q, k, v)),
                lengths=torch.from_numpy(lens), impl="reference"), got),
            (jops, jfaults, lambda: jops.attention(
                *map(jnp.asarray, (q, k, v)), lengths=jnp.asarray(lens),
                impl="reference"), want)):
        inj = fmod.FaultInjector([fmod.FaultSpec("kernel", step=7,
                                                 impl="reference")])
        inj.begin_step(7)
        mod.set_fault_injector(inj)
        try:
            with pytest.raises(RuntimeError) as err:
                call()
        finally:
            mod.set_fault_injector(None)
        out += [inj.fired, str(err.value), type(err.value).__name__]
    assert got == want


def test_ssd_is_never_consulted():
    inj = FaultInjector([FaultSpec("kernel", step=0, impl="torch",
                                   times=None)])
    inj.begin_step(0)
    ops.set_fault_injector(inj)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 2, 8, generator=g)
    dt = torch.rand(1, 16, 2, generator=g)
    a = -torch.rand(2, generator=g)
    b, c = (torch.randn(1, 16, 1, 8, generator=g) for _ in range(2))
    ops.ssd(x, dt, a, b, c, chunk=8, impl="torch")
    assert inj.fired == []


@pytest.mark.parametrize("error", [
    RuntimeError("fused_decode_block: CUDA launch failed with error 700"),
    RuntimeError("nvcc failed for fused_decode_block.cu"),
    ValueError("fused_decode_block: shapes x(2, 1, 32)"),
])
def test_a_real_failure_ends_the_run(error):
    """Only an injected KernelLaunchError rungs down: a launch error, a
    build failure or a wrapper's refusal of a shape (what the kernel
    modules raise) leaves the supervisor unrecovered, with its injector
    uninstalled on the way out and nothing on the ledger."""
    assert not isinstance(error, KernelLaunchError)
    eng, bat = _paged_stack(_qwen())
    bat.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4))

    def broken():
        raise error

    eng.decode_once = broken
    sup = ServingSupervisor(eng, bat, injector=FaultInjector([]))
    with pytest.raises(type(error), match=str(error)[:20]):
        sup.serve(max_steps=4)
    assert ops._fault_injector is None and eng.fault_injector is None
    assert eng.allocator.fault_injector is None
    assert len(sup.ledger) == 0 and eng.demotions == 0


# ---------------------------------------------------------------------------
# the auditor
# ---------------------------------------------------------------------------

_QWEN: dict = {}


def _qwen():
    if not _QWEN:
        cfg = configs.get_config("qwen3-8b", smoke=True)
        _QWEN["v"] = (cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu"))
    return _QWEN["v"]


def _paged_stack(model, num_pages=13):
    cfg, params = model
    plan = make_serving_plan(cfg, 64, device="cpu", paged=True, page_size=8)
    eng = PagedContinuousBatchingEngine(
        params, cfg, batch_size=4, max_len=64, page_size=8,
        num_pages=num_pages, plan=plan, prefill_chunk=16, device="cpu")
    return eng, RequestBatcher(batch_size=4, eos_id=-1, max_len=64)


def test_audit_detects_seeded_corruption():
    """The JAX suite's corruptions, on the port's paged engine: a
    healthy mid-stream engine audits clean, each corruption surfaces as
    its violation, and the repaired state audits clean again."""
    cfg, _ = model = _qwen()
    eng, bat = _paged_stack(model)
    rng = np.random.default_rng(0)
    for u in range(3):
        bat.submit(Request(uid=u, prompt=rng.integers(
            0, cfg.vocab_size, 5 + 3 * u).tolist(), max_new_tokens=6))
    sup = ServingSupervisor(eng, bat)
    for _ in range(3):
        sup.step()
    assert audit_engine(eng, bat) == []
    live = [i for i, a in enumerate(eng.live) if a]
    assert len(live) >= 2
    a, b = live[0], live[1]

    # free/lease overlap
    page = eng.allocator.pages[a][0]
    eng.allocator._free.append(page)
    assert any("both free and leased" in v for v in audit_engine(eng, bat))
    eng.allocator._free.pop()
    assert audit_engine(eng, bat) == []

    # a double lease across keys (which also breaks b's table prefix)
    stolen = eng.allocator.pages[b].pop()
    eng.allocator.pages[a].append(eng.allocator.pages[a][0])
    eng.allocator._free.append(stolen)
    bad = audit_engine(eng, bat)
    assert any("listed twice" in v or "double-leased" in v for v in bad)
    assert any(f"row {b} table" in v for v in bad)
    eng.allocator.pages[a].pop()
    eng.allocator.pages[b].append(eng.allocator._free.pop())
    assert audit_engine(eng, bat) == []

    # a dangling lease; cache_len against row_ctx
    eng.allocator.pages["ghost"] = [eng.allocator._free.pop()]
    assert any("dangling lease" in v for v in audit_engine(eng, bat))
    eng.allocator._free.append(eng.allocator.pages.pop("ghost")[0])
    eng.row_ctx[a] += 1
    assert any("row_ctx" in v for v in audit_engine(eng, bat))
    eng.row_ctx[a] -= 1
    assert audit_engine(eng, bat) == []

    # the device side: a table entry on the null page, a cache_len past
    # max_len, and the batcher's slot length
    eng.state.block_tables[a, 0] = 0
    assert any("null page 0" in v for v in audit_engine(eng, bat))
    eng.state.block_tables[a, 0] = eng.allocator.pages[a][0]
    eng.state.cache_len[b] = 65
    assert any("exceeds max_len" in v for v in audit_engine(eng, bat))
    eng.state.cache_len[b] = eng.row_ctx[b]
    bat.slot_lens[a] += 1
    assert any(f"batcher slot {a} len" in v for v in audit_engine(eng, bat))
    bat.slot_lens[a] -= 1
    assert audit_engine(eng, bat) == []


# ---------------------------------------------------------------------------
# the supervisor's deadline and watchdog paths
# ---------------------------------------------------------------------------

def test_deadline_fails_requests_visibly_and_frees_their_pages():
    """A request leased longer than ``deadline_steps`` is failed, live
    or still prefilling (its side cache dropped and its reservation
    released), with a ledger row; the others finish and the pool ends
    empty."""
    cfg, _ = model = _qwen()
    eng, bat = _paged_stack(model, num_pages=40)
    rng = np.random.default_rng(2)
    for u, n in enumerate((5, 60, 9)):
        bat.submit(Request(uid=u, prompt=rng.integers(
            0, cfg.vocab_size, n).tolist(), max_new_tokens=6 if u else 3))
    sup = ServingSupervisor(eng, bat, deadline_steps=2, audit_every=1)
    seen, deadlines = [], sup._deadlines

    def watched():
        seen.append((sup.t, sorted(eng._pending), eng.live[:3]))
        deadlines()

    sup._deadlines = watched
    fin = sup.serve(max_steps=40)
    # uid 0 finishes at step 1 (its prefill token and two decodes); at
    # step 2 uid 1's 60-token prompt is still prefilling in slot 1 and
    # uid 2 decodes in slot 2
    assert seen[2] == (2, [1], [False, False, True])
    assert [r.uid for r in fin] == [0]
    assert sorted(r.uid for r in sup.failed) == [1, 2]
    assert all(r.failed and r.done for r in sup.failed)
    rows = [i for i in sup.ledger.incidents if i.fault == "deadline"]
    assert len(rows) == 2 and all(
        i.outcome == "failed (deadline exceeded)" for i in rows)
    assert eng.allocator.used_pages == 0 and not eng._pending
    assert audit_engine(eng, bat) == []


def test_watchdog_rows_stay_out_of_the_deterministic_ledger():
    from repro_torch.runtime import StepTimer

    class Flags(StepTimer):
        """Flags every step a straggler."""

        def stop(self) -> bool:
            super().stop()
            return True

    cfg, _ = model = _qwen()
    eng, bat = _paged_stack(model)
    bat.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
    sup = ServingSupervisor(eng, bat, watchdog=Flags())
    sup.serve(max_steps=10)
    rows = sup.ledger.rows(include_timing=True)
    assert [r["fault"] for r in rows] == ["stuck_step"] * sup.t
    assert sup.ledger.to_json() == "[]"
