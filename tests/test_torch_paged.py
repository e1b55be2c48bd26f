"""The port's paged-KV slice against the JAX package's, on the CPU.

* The three paged kernels' plain versions (what their wrappers run for
  a CPU tensor) against the Pallas paged kernels in interpret mode, on
  the same numpy inputs over shuffled tables of a pool larger than the
  batch needs, fp32, atol 1e-5: pages of 8 and 16, a length of 0, a
  dead row whose table row is all zeros, lengths off the page grid,
  Sq > 1 under the causal anchor; and an identity table against the
  dense masked path.
* The ``PageAllocator`` against the JAX one over one sequence of calls.
* ``preempt`` -> ``resume`` round-trips the KV bits and the tokens.
* Token streams, preempt/resume counts and ``peak_used`` against the
  JAX paged engine under page pressure, through both batchers, on the
  setup of ``benchmarks/serving_bench.py`` ``_paged_vs_dense``; and
  paged streams through the fused paths, with ``demotions`` 0 and 1.
* Paged plan resolutions and downgrade ledgers, and the rung-down
  ladder, against ``repro.lower``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import lower as jax_lower
from repro.kernels.fused_attention import (
    fused_attention_masked as pallas_attention_masked,
    fused_attention_paged as pallas_attention_paged)
from repro.kernels.fused_decode_block import (
    fused_decode_block_paged as pallas_decode_block_paged)
from repro.kernels.fused_qproj_attention import (
    fused_qproj_attention_paged as pallas_qproj_paged)
from repro.models import transformer as jax_tf
from repro.serve import OutOfPages as JaxOutOfPages
from repro.serve import PageAllocator as JaxPageAllocator
from repro.serve import PagedContinuousBatchingEngine as JaxPagedEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestBatcher as JaxBatcher
from repro.serve import make_serving_plan as jax_serving_plan

from repro_torch import configs, lower
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.fused_attention import (
    fused_attention_masked, fused_attention_paged)
from repro_torch.kernels.fused_decode_block import fused_decode_block_paged
from repro_torch.kernels.fused_qproj_attention import (
    fused_qproj_attention_paged)
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve import (ContinuousBatchingEngine, OutOfPages,
                               PageAllocator, PagedContinuousBatchingEngine,
                               Request, RequestBatcher, make_serving_plan)
from repro_torch.serve.engine import gather_slot_pages

torch.set_num_threads(2)

ATOL = 1e-5     # fp32: the two sum in different orders, nothing rounds


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _pools(rng, b, hkv, page, max_pages, d, dead=()):
    """Random pools of ``b * max_pages + 5`` pages (more than the batch
    needs) and a table over shuffled, non-contiguous page ids; page 0
    is never mapped, and the rows in ``dead`` get an all-zero table
    row."""
    n_pages = b * max_pages + 5
    kp, vp = (_rand(rng, n_pages, hkv, page, d) for _ in range(2))
    ids = np.arange(1, n_pages)
    rng.shuffle(ids)
    tbl = ids[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    tbl[list(dead)] = 0
    return kp, vp, tbl


# b, hq, hkv, sq, page, max_pages, d, causal, lengths, dead rows
ATTN_CASES = [
    (3, 4, 2, 1, 16, 6, 32, False, [37, 0, 96], ()),   # GQA, a length 0
    (3, 4, 2, 1, 16, 6, 32, True, [37, 0, 96], (1,)),  # dead row: table 0
    (2, 8, 2, 1, 8, 8, 64, True, [3, 61], ()),         # small pages
    (2, 4, 1, 1, 32, 4, 32, True, [100, 128], ()),     # MQA, a full row
    (2, 2, 2, 4, 16, 8, 32, False, [70, 128], ()),     # multi-row chunk
    (2, 6, 2, 5, 8, 8, 32, True, [41, 64], ()),        # Sq > 1, causal
]


@pytest.mark.parametrize("b,hq,hkv,sq,page,max_pages,d,causal,lengths,dead",
                         ATTN_CASES)
def test_attention_paged_plain_matches_pallas(b, hq, hkv, sq, page,
                                              max_pages, d, causal, lengths,
                                              dead):
    rng = np.random.default_rng(0)
    kp, vp, tbl = _pools(rng, b, hkv, page, max_pages, d, dead)
    q, jq = _both(_rand(rng, b, hq, sq, d))
    lens = np.array(lengths, np.int32)
    want = pallas_attention_paged(jq, jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(lens), jnp.asarray(tbl),
                                  causal=causal, interpret=True)
    got = fused_attention_paged(q, torch.from_numpy(kp),
                                torch.from_numpy(vp), torch.from_numpy(lens),
                                torch.from_numpy(tbl), causal=causal)
    _close(got, want)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()          # a row with no column: zeros


# b, hq, hkv, page, max_pages, e, d, lengths, rope, dead rows
FUSED_Q_CASES = [
    (3, 4, 2, 16, 6, 64, 32, [37, 1, 96], 1e4, ()),
    (3, 6, 2, 8, 8, 48, 32, [0, 61, 64], 1e4, (0,)),
    (2, 4, 4, 32, 3, 64, 32, [50, 96], None, ()),
]


@pytest.mark.parametrize("b,hq,hkv,page,max_pages,e,d,lengths,rope,dead",
                         FUSED_Q_CASES)
def test_qproj_and_decode_block_paged_plain_match_pallas(
        b, hq, hkv, page, max_pages, e, d, lengths, rope, dead):
    """The fused-Q and megakernel paged plain versions (RoPE at each
    row's end anchor) against the Pallas paged kernels."""
    rng = np.random.default_rng(1)
    kp, vp, tbl = _pools(rng, b, hkv, page, max_pages, d, dead)
    x, jx = _both(_rand(rng, b, 1, e))
    res, jres = _both(_rand(rng, b, 1, e))
    wq, jwq = _both(_rand(rng, e, hq, d, scale=e ** -0.5))
    wo, jwo = _both(_rand(rng, hq, d, e, scale=(hq * d) ** -0.5))
    lens = np.array(lengths, np.int32)
    jargs = (jnp.asarray(kp), jnp.asarray(vp))
    targs = (torch.from_numpy(kp), torch.from_numpy(vp))
    want = pallas_qproj_paged(jx, jwq, *jargs, jnp.asarray(lens),
                              jnp.asarray(tbl), causal=True,
                              rope_theta=rope, interpret=True)
    got = fused_qproj_attention_paged(x, wq, *targs, torch.from_numpy(lens),
                                      torch.from_numpy(tbl), causal=True,
                                      rope_theta=rope)
    _close(got, want)
    want = pallas_decode_block_paged(jx, jwq, *jargs, jwo, jres,
                                     jnp.asarray(lens), jnp.asarray(tbl),
                                     rope_theta=rope, interpret=True)
    got = fused_decode_block_paged(x, wq, *targs, wo, res,
                                   torch.from_numpy(lens),
                                   torch.from_numpy(tbl), rope_theta=rope)
    _close(got, want)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], res[i])   # length 0: the residual


def test_identity_table_equals_masked_dense():
    """With each row's pages laid out in order, the paged plain version
    gives bit for bit the dense masked plain version on the same
    logical KV, and both match the Pallas masked kernel."""
    b, hq, hkv, page, max_pages, d = 2, 4, 2, 16, 4, 32
    rng = np.random.default_rng(2)
    q, jq = _both(_rand(rng, b, hq, 1, d))
    k, jk = _both(_rand(rng, b, hkv, max_pages * page, d))
    v, jv = _both(_rand(rng, b, hkv, max_pages * page, d))
    lens = np.array([45, 60], np.int32)

    def pool_of(x):
        return x.reshape(b, hkv, max_pages, page, d).movedim(2, 1).reshape(
            b * max_pages, hkv, page, d)

    tbl = torch.arange(b * max_pages, dtype=torch.int32).reshape(b, -1)
    paged = fused_attention_paged(q, pool_of(k), pool_of(v),
                                  torch.from_numpy(lens), tbl)
    dense = fused_attention_masked(q, k, v, torch.from_numpy(lens))
    assert torch.equal(paged, dense)
    assert torch.equal(ref.gather_pages(pool_of(k), tbl), k)
    _close(paged, pallas_attention_masked(jq, jk, jv, jnp.asarray(lens),
                                          causal=True, block_k=page,
                                          interpret=True))


def test_ops_paged_impls_refusals_and_counts():
    """``kernels.ops`` with block tables: every impl agrees with the
    gathered oracle; a float table and a page size off the multiple of
    8 are refused onto the reference with the JAX package's reasons,
    each warned once and recorded on the plan."""
    rng = np.random.default_rng(3)
    b, hq, hkv, page, max_pages, d = 2, 4, 2, 16, 4, 32
    kp, vp, tbl = (torch.from_numpy(a) for a in
                   _pools(rng, b, hkv, page, max_pages, d))
    q = torch.from_numpy(_rand(rng, b, hq, 1, d))
    lens = torch.tensor([10, 50], dtype=torch.int32)
    want = ref.paged_attention_reference(q, kp, vp, lens, tbl, causal=True)
    ops.reset_counts()
    for impl in ("auto", "torch", "reference"):
        got = ops.attention(q, kp, vp, lengths=lens, block_tables=tbl,
                            impl=impl)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    # plan-less auto keys the shape-only plan on the table's depth,
    # 4 pages x 16 = 64 = 2N: the unfused reference
    assert lower.kernel_plan(seq_q=1, seq_kv=max_pages * page, d_head=d,
                             n_heads=hq, n_kv_heads=hkv
                             ).kernel_path == lower.UNFUSED
    assert ops.CALLS[("attention_paged", "torch")] == 1
    assert ops.CALLS[("attention_paged", "reference")] == 2
    assert not build.LAUNCHES
    with pytest.raises(ValueError, match="requires lengths"):
        ops.attention(q, kp, vp, block_tables=tbl)

    cfg = configs.get_config("qwen3-8b", smoke=True)
    lower.clear_plan_cache()
    d = lower.serving_plan(cfg, 256, device="cpu").decode_dispatch(200)
    ops.reset_downgrade_warnings()
    kp12, vp12 = kp[:, :, :12].contiguous(), vp[:, :, :12].contiguous()
    with pytest.warns(UserWarning) as rec:
        for _ in range(2):
            ops.attention(q, kp, vp, lengths=lens, block_tables=tbl.float(),
                          plan=d)
        ops.attention(q, kp12, vp12, lengths=torch.clamp(lens, max=48),
                      block_tables=tbl, plan=d)
    msgs = [str(w.message) for w in rec]
    assert len(msgs) == 2 and all("paged-KV kernel" in m for m in msgs)
    reasons = sorted(g.reason for g in d.plan.downgrades
                     if g.reason.startswith("paged-KV"))
    assert reasons == [
        "paged-KV kernel unavailable: block_tables must be integral, got "
        "torch.float32",
        "paged-KV kernel unavailable: page size 12 not sublane-aligned (8)"]
    # the two above (auto's and the explicit one) and the three refusals
    assert ops.CALLS[("attention_paged", "reference")] == 5


def test_page_allocator_matches_jax():
    """One sequence of alloc/ensure/release on both allocators: the
    same page ids, free counts, refusals, ``peak_used`` and notes."""
    ours, theirs = PageAllocator(9, 16), JaxPageAllocator(9, 16)
    calls = [("alloc", "a", 3), ("ensure", "a", 48), ("ensure", "a", 49),
             ("alloc", "b", 3), ("alloc", "c", 2), ("release", "a"),
             ("alloc", "c", 2), ("ensure", "b", 100), ("release", "a"),
             ("ensure", "c", 17), ("release", "never-leased"),
             ("release", "b"), ("alloc", "d", 5)]
    for call in calls:
        out = []
        for alloc, oop in ((ours, OutOfPages), (theirs, JaxOutOfPages)):
            try:
                out.append(getattr(alloc, call[0])(*call[1:]))
            except oop:
                out.append("OutOfPages")
        assert out[0] == out[1], call
        assert (ours.num_free, ours.used_pages, ours.peak_used,
                ours.pages, ours.notes) == (
            theirs.num_free, theirs.used_pages, theirs.peak_used,
            theirs.pages, theirs.notes), call
    assert ours.peak_used == 7 and len(ours.notes) == 2
    with pytest.raises(ValueError):
        PageAllocator(1, 16)
    with pytest.raises(ValueError):
        PageAllocator(4, 12)


@pytest.mark.parametrize("victim", ["newest", "oldest", "largest"])
def test_page_pressure_policy_picks_as_jax(victim):
    """Each victim order picks the JAX policy's slot over the same
    leases; an unknown order is refused."""
    from types import SimpleNamespace

    from repro.serve.supervisor import PagePressurePolicy as JaxPolicy
    from repro_torch.serve import PagePressurePolicy
    engine = SimpleNamespace(lease_order=[3, 7, 1, 5],
                             allocator=SimpleNamespace(pages={
                                 0: [1, 2], 1: [3], 2: [4, 5, 6], 3: [7]}))
    for live in ([0, 1, 2, 3], [0, 2], [3]):
        assert PagePressurePolicy(victim).pick(engine, live) == \
            JaxPolicy(victim).pick(engine, live)
    with pytest.raises(ValueError):
        PagePressurePolicy("random")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

_WEIGHTS: dict = {}


def _weights(arch):
    """(port cfg, JAX cfg, JAX params, port params on the CPU) for the
    smoke config, shared by this module's tests."""
    if arch not in _WEIGHTS:
        jcfg = jax_configs.get_config(arch, smoke=True)
        jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_config(arch, smoke=True)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _WEIGHTS[arch] = (cfg, jcfg, jparams, params)
    return _WEIGHTS[arch]


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, n).tolist()


def test_preempt_resume_bit_identical():
    """preempt -> resume round-trips the KV bits exactly into other
    pages, and the continuation emits an uninterrupted run's tokens.
    The snapshot is a host copy: another lease's writes to the freed
    pages do not reach it.  The dense engine's preempt/resume, into
    another slot, gives the same tokens."""
    cfg, _, _, params = _weights("qwen3-8b")
    prompt = _prompt(np.random.default_rng(40), cfg, 9)
    other = _prompt(np.random.default_rng(41), cfg, 20)

    def steps(eng, n, row, toks):
        for _ in range(n):
            tokens, inserted = eng.step()
            toks += [first for slot, first in inserted if slot == row]
            toks.append(int(tokens[row]))
        return toks

    def paged():
        return PagedContinuousBatchingEngine(
            params, cfg, batch_size=2, max_len=48, page_size=8,
            num_pages=16, device="cpu")

    eng = paged()
    eng.begin_prefill(0, prompt)
    want = steps(eng, 7, 0, [])

    eng = paged()
    eng.begin_prefill(0, prompt)
    toks = steps(eng, 4, 0, [])
    ids = list(eng.allocator.pages[0])
    before = gather_slot_pages(eng.state, ids)
    pre = eng.preempt(0)
    assert eng.allocator.used_pages == 0 and not eng.live[0]
    eng.begin_prefill(1, other)             # takes and writes freed pages
    eng.step()
    assert set(eng.allocator.pages[1]) >= set(ids)
    eng.resume(pre, 0)
    assert not set(eng.allocator.pages[0]) & set(ids)
    after = gather_slot_pages(eng.state, eng.allocator.pages[0])
    for lb, la in zip(before["scan"], after["scan"]):
        for name in ("k", "v"):
            assert torch.equal(lb["attn"][name], la["attn"][name])
    assert steps(eng, 3, 0, toks) == want

    eng = ContinuousBatchingEngine(params, cfg, batch_size=2, max_len=48,
                                   device="cpu")
    eng.begin_prefill(0, prompt)
    toks = steps(eng, 4, 0, [])
    pre = eng.preempt(0)
    eng.begin_prefill(0, other)             # overwrites row 0's cache
    eng.step()
    with pytest.raises(ValueError):
        eng.resume(pre, 0)
    eng.resume(pre, 1)
    assert steps(eng, 3, 1, toks) == want


def test_page_pool_exhaustion_raises_and_step_is_rerunnable():
    """A pool of one usable page: the step that needs a second page
    raises OutOfPages (no relief: the lone request is the pool's only
    tenant) and leaves the engine's state as it was."""
    cfg, _, _, params = _weights("qwen3-8b")
    eng = PagedContinuousBatchingEngine(params, cfg, batch_size=1,
                                        max_len=16, page_size=8,
                                        num_pages=2, device="cpu")
    assert not eng.can_admit_tokens(8) and eng.can_admit_tokens(5)
    eng.begin_prefill(0, _prompt(np.random.default_rng(60), cfg, 5))
    for _ in range(3):
        eng.step()
    assert eng.row_ctx[0] == 8
    tables = eng.state.block_tables.clone()
    for _ in range(2):
        with pytest.raises(OutOfPages):
            eng.step()
        assert eng.row_ctx[0] == 8 and torch.equal(eng.state.block_tables,
                                                   tables)


def test_paged_attention_refusals():
    """The JAX model's refusals: paged KV without a cache (prefill runs
    dense) and paged KV without a per-row (B,) cache_len."""
    from repro_torch.models.attention import gqa_forward
    cfg, _, _, params = _weights("qwen3-8b")
    lp = {k: v[0] for k, v in params["layers"][0]["attn"].items()}
    x = torch.zeros(2, 1, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    tbl = torch.zeros(2, 4, dtype=torch.int32)
    pool = torch.zeros(5, cfg.kv_heads, 8, cfg.head_dim)
    with pytest.raises(NotImplementedError, match="prefill runs dense"):
        gqa_forward(lp, cfg, x, pos, block_tables=tbl)
    with pytest.raises(NotImplementedError, match="per-row"):
        gqa_forward(lp, cfg, x, pos, cache={"k": pool, "v": pool.clone()},
                    cache_len=3, block_tables=tbl)


def _count_verbs(eng):
    """Wrap ``eng.preempt``/``resume``/``step`` to count preemptions,
    resumptions and the peak number of live rows."""
    counts = {"preempt": 0, "resume": 0, "peak_live": 0}
    orig_pre, orig_res, orig_step = eng.preempt, eng.resume, eng.step

    def preempt(slot):
        counts["preempt"] += 1
        return orig_pre(slot)

    def resume(pre, slot):
        counts["resume"] += 1
        return orig_res(pre, slot)

    def step():
        counts["peak_live"] = max(counts["peak_live"], sum(eng.live))
        return orig_step()

    eng.preempt, eng.resume, eng.step = preempt, resume, step
    return counts


def _stream(cfg, lens, budget, seed):
    """(uid, prompt, budget) requests with prompts of the lengths
    ``lens``, tokens drawn uniformly."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, cfg.vocab_size, size=n).tolist(), budget)
            for uid, n in enumerate(lens)]


def _serve_both(arch, stream, *, batch, max_len, chunk, page, num_pages,
                demotions=0):
    """The stream through the JAX paged engine and the port's, each
    driven by its own batcher.  Returns (JAX tokens, port tokens, JAX
    engine and counts, port engine and counts, port plan)."""
    cfg, jcfg, jparams, params = _weights(arch)
    jax_lower.clear_plan_cache()
    lower.clear_plan_cache()
    jeng = JaxPagedEngine(jparams, jcfg, batch_size=batch, max_len=max_len,
                          plan=jax_serving_plan(jcfg, max_len, paged=True,
                                                page_size=page),
                          prefill_chunk=chunk, page_size=page,
                          num_pages=num_pages)
    plan = make_serving_plan(cfg, max_len, device="cpu", paged=True,
                             page_size=page)
    eng = PagedContinuousBatchingEngine(
        params, cfg, batch_size=batch, max_len=max_len, plan=plan,
        prefill_chunk=chunk, page_size=page, num_pages=num_pages,
        device="cpu")
    jeng.demotions = eng.demotions = demotions
    out = []
    for e, batcher, req in ((jeng, JaxBatcher, JaxRequest),
                            (eng, RequestBatcher, Request)):
        counts = _count_verbs(e)
        bt = batcher(batch_size=batch, eos_id=-1, max_len=max_len)
        for uid, prompt, budget in stream:
            bt.submit(req(uid=uid, prompt=prompt, max_new_tokens=budget))
        ops.reset_counts()
        done = bt.serve(e, max_steps=400)
        out.append(({r.uid: list(r.generated) for r in done}, counts))
    (jtoks, jcounts), (toks, counts) = out
    return jtoks, toks, (jeng, jcounts), (eng, counts), plan


def test_page_pressure_streams_match_jax():
    """The serving bench's paged-vs-dense setup (smoke starcoder2-7b,
    page 8, 25 pages, batch 6, max_len 96, chunk 16, 9 requests of 6
    tokens): the same tokens, preemptions, resumptions and peak pool
    use as the JAX paged engine, and the port's dense engine's
    tokens."""
    cfg = _weights("starcoder2-7b")[0]
    rng = np.random.default_rng(1)       # serving_bench's _request_stream
    stream = [(uid, rng.integers(0, cfg.vocab_size,
                                 size=int(rng.integers(8, 41))).tolist(), 6)
              for uid in range(9)]
    jtoks, toks, (jeng, jc), (eng, c), _ = _serve_both(
        "starcoder2-7b", stream, batch=6, max_len=96, chunk=16, page=8,
        num_pages=25)
    assert toks == jtoks and len(toks) == 9
    assert all(len(t) == 6 for t in toks.values())
    assert c["preempt"] == jc["preempt"] > 0
    assert c["resume"] == jc["resume"] == c["preempt"]
    assert eng.allocator.peak_used == jeng.allocator.peak_used
    assert eng.allocator.used_pages == 0 and not eng.allocator.notes

    dense = ContinuousBatchingEngine(
        _weights("starcoder2-7b")[3], cfg, batch_size=6, max_len=96,
        plan=make_serving_plan(cfg, 96, device="cpu"), prefill_chunk=16,
        device="cpu")
    bt = RequestBatcher(batch_size=6, eos_id=-1, max_len=96)
    for uid, prompt, budget in stream:
        bt.submit(Request(uid=uid, prompt=prompt, max_new_tokens=budget))
    assert {r.uid: list(r.generated) for r in bt.serve(dense)} == toks


@pytest.mark.parametrize("arch,demotions,entry", [
    ("starcoder2-7b", 0, "decode_block"),
    ("starcoder2-7b", 1, "qproj_attention"),
    ("qwen3-8b", 0, "attention"),
])
def test_fused_paged_streams_match_jax(arch, demotions, entry):
    """Decode past C = 2N = 64 on the paged fused paths: the megakernel
    (#6) for starcoder2, one rung down (#5) with ``demotions = 1``, and
    fused attention (#4) for the qk-norm qwen3.  The first two leases
    fill the pool (11 + 10 of 21 pages); both rows cross a page edge
    in their third step, so the newest is preempted and resumes when
    the first finishes.  The same tokens, preemptions and peak pool use
    as the JAX paged engine with the same demotions."""
    cfg = _weights(arch)[0]
    stream = _stream(cfg, (86, 78, 70), 4, seed=5)
    jtoks, toks, (jeng, jc), (eng, c), plan = _serve_both(
        arch, stream, batch=2, max_len=128, chunk=48, page=8, num_pages=22,
        demotions=demotions)
    assert toks == jtoks and all(len(t) == 4 for t in toks.values())
    assert c["preempt"] == jc["preempt"] > 0
    assert c["resume"] == jc["resume"] == c["preempt"]
    assert c["peak_live"] == jc["peak_live"] == 2
    assert eng.allocator.peak_used == jeng.allocator.peak_used
    assert ops.CALLS[(f"{entry}_paged", "torch")] > 0
    assert not any(k[0].endswith("_paged") and k[1] == "reference"
                   for k in ops.CALLS)
    if demotions:
        assert any("rung-down decode_megakernel/torch -> qproj_attention"
                   in g.reason for g in plan.downgrades())


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _ledger(dispatches, impl_name):
    """Downgrade records of the dispatches' plans, in first-seen order,
    with the JAX impl names mapped onto the port's."""
    seen, out = set(), []
    for d in dispatches:
        if id(d.plan) in seen:
            continue
        seen.add(id(d.plan))
        out.append([(g.reason.replace(f"'{impl_name}'", "'IMPL'"),
                     g.from_path, g.to_path, g.count)
                    for g in d.plan.downgrades])
    return out


def _drive(plan, n):
    """Dispatches across the prefill crossover M = N and the decode
    crossover C = 2N, chunks and whole-batch steps."""
    out = []
    for rows in (1, n - 1, n, n + 1, 4 * n):
        out.append(plan.prefill_dispatch(rows))
    for ctx in (1, 2 * n - 1, 2 * n, 2 * n + 1, 3 * n, 8 * n):
        out.append(plan.decode_dispatch(ctx))
    for rows in (1, n, 48):
        for ctx in (rows, rows + 1, 2 * n + 1, 6 * n + 7):
            out.append(plan.chunk_dispatch(ctx, rows))
    for lens in ([0], [2 * n - 1, 3], [2 * n, 1], [5 * n, 0, 2 * n]):
        out.append(plan.step_dispatch(lens))
    return out


@pytest.mark.parametrize("arch", configs.list_archs("dense"))
def test_paged_plans_and_ledgers_match_jax(arch):
    """The same (phase, n, bucket, path) resolutions and the same
    downgrade ledgers as ``repro.lower`` with ``paged=True`` on the CPU,
    where both gather the pool (the JAX 'xla' impl is the port's
    'torch').  On 'cuda' a paged dispatch is a note, never a
    downgrade."""
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    lower.clear_plan_cache()
    jax_lower.clear_plan_cache()
    ours = lower.serving_plan(cfg, 2048, device="cpu", paged=True,
                              page_size=16)
    theirs = jax_lower.serving_plan(jcfg, 2048, paged=True, page_size=16)
    n = cfg.head_dim
    got, want = _drive(ours, n), _drive(theirs, n)
    assert [r[:4] for r in ours.resolutions] == \
        [r[:4] for r in theirs.resolutions]
    assert all(d.paged for d in got)
    assert _ledger(got, "torch") == _ledger(want, "xla")
    assert any("pool gathered to masked-dense" in g.reason
               for g in ours.downgrades())
    with pytest.raises(ValueError, match="multiple of page_size"):
        lower.serving_plan(cfg, 100, device="cpu", paged=True, page_size=16)

    lower.clear_plan_cache()
    plan = lower.resolve_plan(cfg, "decode", 600, n_blocks=cfg.n_layers)
    d = lower.dispatch(plan, device="cuda", entry="decode_block",
                       qk_norm=cfg.qk_norm, lengths_masked=True, paged=True)
    assert d.impl == "cuda" and d.paged and not any(
        "paged" in g.reason for g in plan.downgrades)
    assert any("paged KV" in note for note in plan.notes)


@pytest.mark.parametrize("arch", configs.list_archs("dense"))
def test_rung_down_ladder_matches_jax(arch):
    """From the planned decode path down to the bottom rung: the JAX
    ladder ends unfused/reference -> unfused/xla, the port's
    unfused/reference -> unfused/torch (its chunked plain path), then
    both return None.  The recorded steps match."""
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    lower.clear_plan_cache()
    jax_lower.clear_plan_cache()
    ours = lower.serving_plan(cfg, 1024, device="cpu").decode_dispatch(600)
    theirs = jax_lower.serving_plan(jcfg, 1024).decode_dispatch(600)
    seq, jseq = [], []
    while ours is not None:
        seq.append((ours.path, ours.impl))
        ours = lower.rung_down(ours, "test")
    while theirs is not None:
        jseq.append((theirs.path, theirs.impl.replace("xla", "torch")))
        theirs = jax_lower.runtime.rung_down(theirs, "test")
    assert seq == jseq
    assert seq[-2:] == [(lower.UNFUSED, "reference"),
                        (lower.UNFUSED, "torch")]
    if not cfg.qk_norm:
        assert seq[0] == (lower.DECODE_MEGAKERNEL, "torch") and len(seq) == 5
