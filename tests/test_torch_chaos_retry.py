"""Retry safety of the port's engines, proven on the CPU rather than
assumed, and the Mamba-2 quarantine finding.

The port writes KV in place before the attention call that may raise,
and advances ``cache_len`` (decode) or a prefill's ``pos`` only after
the whole forward ran.  So a ``KernelLaunchError`` at layer k leaves
layers <= k with K/V written past each row's length, which the
supervisor's retry writes again.  A test-only injector raises at the
k-th attention call of one prefill chunk or one decode step (k = the
first, a middle and the last layer of a 5-layer qwen3-8b smoke model),
on the dense and the paged engine: the supervised stream's tokens, and
every step's ``cache_len`` and host context, equal the fault-free
run's.  The prefill case raises in the second pending request's chunk
after the first one completed, which the insert backlog must report;
the engine-level test shows both first tokens reach the caller.

The Mamba-2 finding: the JAX engine's ``rollback_slot`` rewinds the
length and last token of a NaN-quarantined row but not its conv tail
and SSM state, which the decode step already advanced, so its stream
after the quarantine differs from the fault-free one (pinned below on
mamba2-130m smoke).  The port refuses the rollback instead.
"""

import dataclasses

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
from repro_torch.kernels.ops import KernelLaunchError
from repro_torch.models.weights import init_params, params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine, FaultInjector,
                               FaultSpec, PagedContinuousBatchingEngine,
                               Request, RequestBatcher, ServingSupervisor,
                               make_serving_plan)

torch.set_num_threads(2)

LAYERS = 5
#: prompts of 9, 20, 13 and 26 tokens in chunks of 8, batch 3: step 0
#: runs three first chunks; step 1 completes the 9-token prompt, then
#: runs the 20-token prompt's second chunk, then completes the 13-token
#: one, and decodes; step 3 only decodes
PROMPT_LENS, CHUNK, BATCH, MAX_LEN, BUDGET = (9, 20, 13, 26), 8, 3, 64, 6
PREFILL_STEP, DECODE_STEP = 1, 3


@pytest.fixture(autouse=True)
def _no_injector_left():
    """``tests/conftest.py`` clears only the JAX package's hook."""
    ops.set_fault_injector(None)
    yield
    ops.set_fault_injector(None)


class LayerFault(FaultInjector):
    """Raises ``KernelLaunchError`` once, at the ``k``-th attention call
    (``on_kernel`` consultation) of ``phase`` on scheduler step
    ``step``; ``phase`` None counts every call of the step.  The phase
    is set by :func:`_tag_phases`."""

    def __init__(self, step: int, phase, k: int):
        super().__init__([])
        self.at = (step, phase, k)
        self.phase = None
        self.seen = 0

    def begin_step(self, t: int) -> None:
        super().begin_step(t)
        self.seen = 0

    def on_kernel(self, entry: str, impl: str) -> None:
        step, phase, k = self.at
        if self._step != step or phase not in (None, self.phase):
            return
        self.seen += 1
        if self.seen == k and not self.fired:
            self.fired.append((step, "kernel", f"{entry}/{impl}"))
            raise KernelLaunchError(f"injected at call {k} of {phase}")


def _tag_phases(inj, eng) -> None:
    """Wrap the engine's two launch phases so ``inj.phase`` names the
    one running."""
    for phase, name in (("prefill", "_advance_prefills"),
                        ("decode", "decode_once")):
        def run(fn=getattr(eng, name), phase=phase):
            inj.phase = phase
            try:
                return fn()
            finally:
                inj.phase = None
        setattr(eng, name, run)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.get_config("qwen3-8b", smoke=True),
                              n_layers=LAYERS)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(model, paged: bool):
    cfg, params = model
    plan = make_serving_plan(cfg, MAX_LEN, device="cpu", paged=paged,
                             page_size=8 if paged else None)
    kw = dict(batch_size=BATCH, max_len=MAX_LEN, plan=plan,
              prefill_chunk=CHUNK, device="cpu")
    if paged:
        return PagedContinuousBatchingEngine(params, cfg, page_size=8,
                                             num_pages=32, **kw)
    return ContinuousBatchingEngine(params, cfg, **kw)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def _supervised(model, paged, inj=None):
    """(tokens, per-step (cache_len, row_ctx), supervisor)."""
    eng = _engine(model, paged)
    bat = RequestBatcher(BATCH, eos_id=-1, max_len=MAX_LEN)
    for uid, p in enumerate(_prompts(model[0])):
        bat.submit(Request(uid=uid, prompt=p, max_new_tokens=BUDGET))
    if inj is not None:
        _tag_phases(inj, eng)
    sup = ServingSupervisor(eng, bat, injector=inj, audit_every=1)
    trace = []
    step = sup.step

    def traced():
        step()
        trace.append((eng.state.cache_len.tolist(), list(eng.row_ctx)))

    sup.step = traced
    fin = sup.serve(max_steps=100)
    return {r.uid: r.generated for r in fin}, trace, sup


@pytest.fixture(scope="module")
def fault_free(model):
    return {paged: _supervised(model, paged)[:2] for paged in (False, True)}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("layer", [1, 3, LAYERS])
def test_a_raise_at_any_layer_is_retried_to_the_fault_free_stream(
        model, fault_free, paged, phase, layer):
    # the prefill fault lands in the second pending request's chunk
    k = layer + (LAYERS if phase == "prefill" else 0)
    step = PREFILL_STEP if phase == "prefill" else DECODE_STEP
    inj = LayerFault(step, phase, k)
    tokens, trace, sup = _supervised(model, paged, inj)
    want_tokens, want_trace = fault_free[paged]
    assert len(inj.fired) == 1
    assert tokens == want_tokens
    assert all(len(t) == BUDGET for t in tokens.values())
    assert trace == want_trace
    actions = [(i.step, i.action) for i in sup.ledger.incidents]
    assert (step, "rung-down to demotion level 1") in actions
    assert (step, f"{phase} retry succeeded") in actions


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_backlog_reports_a_first_token_whose_neighbour_raised(model, paged):
    """Two prompts that each complete in one chunk: the first inserts,
    the second's chunk raises at its first layer.  The first row is
    live, its token waits on the backlog, and the retry returns both
    first tokens, the fault-free ones."""
    cfg, _ = model
    prompts = _prompts(cfg)[:1] + [_prompts(cfg)[2][:CHUNK]]
    want = _engine(model, paged)
    for slot, p in enumerate(prompts):
        want.begin_prefill(slot, p[:CHUNK])
    want = want._advance_prefills()

    eng = _engine(model, paged)
    for slot, p in enumerate(prompts):
        eng.begin_prefill(slot, p[:CHUNK])
    inj = LayerFault(0, None, LAYERS + 1)
    inj.begin_step(0)
    ops.set_fault_injector(inj)
    with pytest.raises(KernelLaunchError):
        eng._advance_prefills()
    assert eng.live[0] and not eng.live[1]
    assert eng._insert_backlog == want[:1]
    assert eng._advance_prefills() == want
    assert len(want) == 2 and eng.live == [True, True, False]
    assert eng._insert_backlog == []


# ---------------------------------------------------------------------------
# the Mamba-2 quarantine finding
# ---------------------------------------------------------------------------

MAMBA_PROMPTS, MAMBA_NAN = (44, 90, 49, 58), dict(kind="nan", step=3, slot=0)


def _mamba_run(mod, cfg, params, inj, **kw):
    rng = np.random.default_rng(7)
    eng = mod.ContinuousBatchingEngine(params, cfg, batch_size=3,
                                       max_len=160, prefill_chunk=48, **kw)
    bat = mod.RequestBatcher(3, max_len=160)
    for uid, n in enumerate(MAMBA_PROMPTS):
        bat.submit(mod.Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).tolist(), max_new_tokens=6))
    sup = mod.ServingSupervisor(eng, bat, injector=inj, audit_every=1)
    return sup, eng


def test_mamba_quarantine_diverges_in_jax_and_the_port_refuses():
    """JAX: one NaN quarantine of a mamba2 row changes that request's
    later tokens (its SSM state stays one step ahead of the rewound
    length).  The port: the fault-free supervised run gives JAX's
    tokens; the same fault raises NotImplementedError naming the state,
    with the injector uninstalled."""
    jcfg = jax_configs.get_config("mamba2-130m", smoke=True)
    jparams, _ = init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config("mamba2-130m", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")

    def tokens(sup):
        return {r.uid: list(r.generated) for r in sup.serve(max_steps=200)}

    base = tokens(_mamba_run(J, jcfg, jparams, None)[0])
    inj = J.FaultInjector([J.FaultSpec(**MAMBA_NAN)])
    sup, _ = _mamba_run(J, jcfg, jparams, inj)
    faulted = tokens(sup)
    assert inj.fired == [(3, "nan", "slot 0")]
    assert [i.action for i in sup.ledger.incidents] == [
        "quarantine: rollback + preempt"]
    assert faulted != base                   # the reference's fault
    assert faulted[0][:4] == base[0][:4] and faulted[0][4:] != base[0][4:]
    assert {u: t for u, t in faulted.items() if u} == \
        {u: t for u, t in base.items() if u}

    assert tokens(_mamba_run(P, cfg, params, None,
                             device="cpu")[0]) == base
    inj = FaultInjector([FaultSpec(**MAMBA_NAN)])
    sup, eng = _mamba_run(P, cfg, params, inj, device="cpu")
    with pytest.raises(NotImplementedError, match="SSM state"):
        sup.serve(max_steps=200)
    assert inj.fired == [(3, "nan", "slot 0")]
    assert ops._fault_injector is None and eng.fault_injector is None

