"""Layer-fusion schedules for attention heads (paper Sec. IV) and the
schedule explorer that rediscovers them.

Three named schedules (Fig. 5):

* ``lbl``        — layer-by-layer, memory-optimal ordering (Fig. 5a).
* ``fuse_q_qkt`` — fuse Q -> QK^T (optimal for M < N, Fig. 5b): rows of Q
                   are consumed immediately and never stored.
* ``fuse_pv``    — fuse QK^T -> softmax -> (QK^T)V (optimal for M > N,
                   Fig. 5c): the M x M score matrix is never stored; the
                   softmax runs on the SIMD core inside the pipeline.

``explore`` evaluates a schedule space with the Step-5 scheduler — the
engine *rediscovers* the paper's optima rather than hard-coding them
(tests assert the discovered peak equals analytical.a_lf / a_lbl).
Given an (M, N) pair it searches the named attention-head presets;
given any ``Workload`` (FFN, GQA attention, a full transformer block
from ``workload.from_model_config``) the space comes from the generic
generator in ``core/spacegen.py``.  The presets themselves are thin
wrappers over ``spacegen.chain_schedule``, so hand-written and
generated schedules share one assembly path.

``select_schedule`` is the shape-driven decision rule the paper
concludes with, reused by the runtime (models/attention.py) to pick the
matching kernel path.

A copy of the JAX package's ``repro/core/fusion.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Union

from repro_torch.core import analytical
from repro_torch.core import scheduler as sch
from repro_torch.core import spacegen
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import Accelerator, pe_array_64x64


def lbl(prefix: str = "", core: int = 0,
        qkv_order: tuple[str, ...] = ("Q", "K", "V")) -> sch.Schedule:
    """Fig. 5a (memory-optimal layer-by-layer).  The paper notes V and
    QK^T may be swapped without changing latency or peak memory."""
    p = prefix
    names = [f"{p}{n}" for n in qkv_order] + [f"{p}QKT", f"{p}SM", f"{p}AV"]
    return spacegen.chain_schedule(f"lbl[{''.join(qkv_order)}]", names,
                                   core=core)


def fuse_q_qkt(prefix: str = "", core: int = 0) -> sch.Schedule:
    """Fig. 5b (optimal for M < N): K first, then Q fused into QK^T
    (Q streamed), then V, softmax, AV."""
    p = prefix
    return spacegen.chain_schedule(
        "fuse[Q->QKT]",
        [f"{p}K", f"{p}Q", f"{p}QKT", f"{p}V", f"{p}SM", f"{p}AV"],
        fused={(f"{p}Q", f"{p}QKT")}, core=core)


def fuse_pv(prefix: str = "", core: int = 0,
            kvq_order: tuple[str, ...] = ("K", "V", "Q")) -> sch.Schedule:
    """Fig. 5c (optimal for M > N): K, V, Q layer-by-layer, then
    QK^T -> softmax -> .V fused (score rows streamed through the SIMD
    core, one Q row substituted by one output row)."""
    p = prefix
    order = [f"{p}{n}" for n in kvq_order] \
        + [f"{p}QKT", f"{p}SM", f"{p}AV"]
    return spacegen.chain_schedule(
        "fuse[QKT->SM->AV]", order,
        fused={(f"{p}QKT", f"{p}SM"), (f"{p}SM", f"{p}AV")}, core=core)


def fuse_all(prefix: str = "", core: int = 0) -> sch.Schedule:
    """The Fig. 5c-caption alternative: fuse Q, QK^T (and onwards) instead
    of computing Q completely first."""
    p = prefix
    return spacegen.chain_schedule(
        "fuse[Q->QKT->SM->AV]",
        [f"{p}K", f"{p}V", f"{p}Q", f"{p}QKT", f"{p}SM", f"{p}AV"],
        fused={(f"{p}Q", f"{p}QKT"), (f"{p}QKT", f"{p}SM"),
               (f"{p}SM", f"{p}AV")}, core=core)


def softmax_offload(prefix: str = "", core: int = 0, sm_core: int = 1,
                    policy: str = "fuse_pv") -> sch.Schedule:
    """One head with its softmax migrated to ``sm_core`` (a SIMD-heavy
    core on a heterogeneous platform): the matmul chain stays on
    ``core``.  Under an unfused policy the score matrix crosses the
    link as a whole tensor; under a fusing policy the score pipeline's
    intra-stage edges become *cross-core streamed* edges — QK^T rows
    forwarded to the SIMD core and softmax rows forwarded back, double
    buffered on the link, never parked in either L1 (the engine's
    cross-core streamed-edge model; cf. ``split_head_pipeline``)."""
    if sm_core == core:
        raise ValueError(
            "softmax_offload needs a distinct SIMD core; same-core "
            "schedules are the named presets (lbl/fuse_pv/...)")
    p = prefix
    qkt, sm, av = f"{p}QKT", f"{p}SM", f"{p}AV"
    if policy == "lbl":
        pre = [sch.Stage(layers=(f"{p}{n}",), core=core)
               for n in ("Q", "K", "V")]
        pre.append(sch.Stage(layers=(qkt,), core=core))
        stages = pre + [sch.Stage(layers=(sm,), core=sm_core),
                        sch.Stage(layers=(av,), core=core)]
    elif policy == "fuse_q_qkt":
        stages = [
            sch.Stage(layers=(f"{p}K",), core=core),
            sch.Stage(layers=(f"{p}Q", qkt),
                      streamed=frozenset({(f"{p}Q", qkt)}), core=core),
            sch.Stage(layers=(f"{p}V",), core=core),
            sch.Stage(layers=(sm,), core=sm_core),
            sch.Stage(layers=(av,), core=core),
        ]
    elif policy in ("fuse_pv", "fuse_all"):
        if policy == "fuse_all":
            pre = [sch.Stage(layers=(f"{p}K",), core=core),
                   sch.Stage(layers=(f"{p}V",), core=core),
                   sch.Stage(layers=(f"{p}Q", qkt),
                             streamed=frozenset({(f"{p}Q", qkt)}),
                             core=core)]
        else:
            pre = [sch.Stage(layers=(f"{p}{n}",), core=core)
                   for n in ("K", "V", "Q")]
            pre.append(sch.Stage(layers=(qkt,), core=core))
        stages = pre + [
            sch.Stage(layers=(sm,), streamed=frozenset({(qkt, sm)}),
                      core=sm_core),
            sch.Stage(layers=(av,), streamed=frozenset({(sm, av)}),
                      core=core),
        ]
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return sch.Schedule(
        name=f"offload[{policy}]@{core}->sm{sm_core}",
        stages=tuple(stages))


def candidates(prefix: str = "", core: int = 0) -> list[sch.Schedule]:
    """The named preset space for one attention head: QKV orderings for
    LBL plus every fusion pattern.  Each entry is a point of the
    generic ``spacegen.generate`` space (pinned by
    tests/test_spacegen.py); the presets exist so the paper's Fig. 5
    schedules keep their names and enumeration order."""
    out: list[sch.Schedule] = []
    for perm in itertools.permutations(("Q", "K", "V")):
        out.append(lbl(prefix, core, qkv_order=perm))
    out.append(fuse_q_qkt(prefix, core))
    for perm in itertools.permutations(("K", "V", "Q")):
        out.append(fuse_pv(prefix, core, kvq_order=perm))
    out.append(fuse_all(prefix, core))
    return out


def split_head_pipeline(prefix: str = "", proj_core: int = 0,
                        attn_core: int = 1) -> sch.Schedule:
    """Pipeline one head across two cores: the projections run on
    ``proj_core`` while the fused score pipeline runs on ``attn_core``
    with Q *streamed over the interconnect* (a cross-core streamed edge
    — rows of Q are forwarded through the link as they are produced and
    never occupy the projection core's L1)."""
    p = prefix
    return sch.Schedule(
        name=f"split[{proj_core}->{attn_core}]",
        stages=(
            sch.Stage(layers=(f"{p}K",), core=proj_core),
            sch.Stage(layers=(f"{p}V",), core=proj_core),
            sch.Stage(layers=(f"{p}Q",), core=proj_core),
            sch.Stage(
                layers=(f"{p}QKT", f"{p}SM", f"{p}AV"),
                streamed=frozenset({(f"{p}Q", f"{p}QKT"),
                                    (f"{p}QKT", f"{p}SM"),
                                    (f"{p}SM", f"{p}AV")}),
                core=attn_core,
            ),
        ),
    )


def multi_head_candidates(n_heads: int, n_cores: int) -> list[sch.Schedule]:
    """Schedule space for ``n_heads`` parallel heads on ``n_cores`` cores:
    every fusion policy crossed with head->core placements (all heads on
    core 0, round-robin data parallelism over heads) plus the cross-core
    split-head pipeline when at least two cores exist."""
    builders = (("lbl", lbl), ("fuse_q_qkt", fuse_q_qkt),
                ("fuse_pv", fuse_pv), ("fuse_all", fuse_all))
    allocs = {"c0": tuple(0 for _ in range(n_heads))}
    if n_cores > 1:
        allocs["rr"] = tuple(h % n_cores for h in range(n_heads))
    out: list[sch.Schedule] = []
    for pname, builder in builders:
        for aname, alloc in allocs.items():
            stages: list[sch.Stage] = []
            for h, c in enumerate(alloc):
                stages.extend(builder(f"h{h}.", c).stages)
            out.append(sch.Schedule(
                name=f"heads{n_heads}[{pname}]@{aname}",
                stages=tuple(stages)))
    if n_cores > 1:
        stages = []
        for h in range(n_heads):
            stages.extend(split_head_pipeline(
                f"h{h}.", proj_core=h % n_cores,
                attn_core=(h + 1) % n_cores).stages)
        out.append(sch.Schedule(
            name=f"heads{n_heads}[split]@pipe", stages=tuple(stages)))
    return out


@dataclasses.dataclass
class ExplorationResult:
    """One explored (schedule, Result) pair; the repr prints latency
    in Mcycles and peak active memory in words + KiB so benchmark
    tables read unambiguously."""

    schedule: sch.Schedule
    result: sch.Result

    def __repr__(self) -> str:
        r = self.result
        return (f"<{self.schedule.name}: "
                f"{r.latency_mcycles:.3f} Mcycles, "
                f"peak {r.peak_active_words} words "
                f"({sch._kib(r.peak_active_words)})>")


def explore(workload: Union[int, wl.Workload], N: Optional[int] = None,
            accel: Optional[Accelerator] = None,
            row_block: Optional[int] = None,
            latency_tolerance: float = 1.02,
            n_heads: int = 1,
            space: Optional[spacegen.SpaceOptions] = None,
            ) -> list[ExplorationResult]:
    """Evaluate a candidate schedule space and return the survivors
    sorted by (peak active memory, latency).

    Two entry points share this engine:

    * ``explore(M, N, ...)`` — the paper's M x N attention head over
      the named preset space (``candidates``; with ``n_heads > 1`` the
      multi-head multi-core space of ``multi_head_candidates`` over
      a ``parallel_heads`` workload, communication booked on the
      interconnect so a multi-core candidate only wins when its
      transfer cost is actually paid for).
    * ``explore(some_workload, ...)`` — *any* ``Workload`` DAG (FFN,
      GQA attention, a full transformer block built by
      ``workload.from_model_config``); the space comes from the
      generic generator ``spacegen.generate`` over ``accel``'s cores,
      bounded by ``space`` (a ``spacegen.SpaceOptions``).

    ``latency_tolerance``: the paper searches for fused schedules at the
    *same optimal latency* as LBL; candidates slower than
    tolerance x best-latency are dropped.

    Args:
        workload: M (rows, int) for the paper's head — or any
                  ``Workload``.
        N:        head dim (only with the (M, N) entry point).
        accel:    platform description (default ``pe_array_64x64``).
        row_block: node granularity in rows (default: ~64 nodes per
                  layer).

    Returns the surviving ``ExplorationResult`` list, best first
    (lowest peak active words, then lowest latency cycles).

    >>> best = explore(4, 8)[0]           # M < N: fuse Q -> QK^T
    >>> best.schedule.name
    'fuse[Q->QKT]'
    >>> best.result.peak_active_words     # == analytical.a_lf(4, 8)
    80
    """
    accel = accel or pe_array_64x64()
    if isinstance(workload, wl.Workload):
        if N is not None or n_heads != 1:
            raise TypeError(
                "N/n_heads apply only to the explore(M, N) entry "
                "point; with a Workload first argument, build the "
                "heads into the workload itself")
        net = workload
        cands = spacegen.generate(net, n_cores=accel.n_cores,
                                  options=space, accel=accel)
        if row_block is None:
            rows = max(l.rows for l in net.layers.values())
            row_block = max(1, rows // 64)
    else:
        M = workload
        if N is None:
            raise TypeError("explore(M, N): N is required when the "
                            "first argument is a dimension")
        if row_block is None:
            row_block = max(1, M // 256)  # keep node counts bounded
        if n_heads == 1:
            net = wl.attention_head(M, N)
            cands = candidates()
        else:
            net = wl.parallel_heads(M, N, n_heads)
            cands = multi_head_candidates(n_heads, accel.n_cores)
    evals: list[ExplorationResult] = []
    for cand in cands:
        try:
            res = sch.evaluate(net, accel, cand, row_block=row_block)
        except sch.IllegalSchedule:
            continue
        evals.append(ExplorationResult(cand, res))
    if not evals:
        raise sch.IllegalSchedule("no legal schedule found")
    best_lat = min(e.result.latency_cycles for e in evals)
    evals = [e for e in evals
             if e.result.latency_cycles <= latency_tolerance * best_lat]
    evals.sort(key=lambda e: (e.result.peak_active_words,
                              e.result.latency_cycles))
    return evals


def best_schedule(workload: Union[int, wl.Workload],
                  N: Optional[int] = None, **kw) -> ExplorationResult:
    """The (peak, latency)-optimal schedule; accepts the same
    (M, N) / Workload entry points as ``explore``."""
    return explore(workload, N, **kw)[0]


# ---------------------------------------------------------------------------
# The paper's shape-driven decision rule, exported to the runtime
# ---------------------------------------------------------------------------

def select_schedule(M: int, N: int) -> str:
    """Paper take-away (Sec. IV.C.3): fuse through the largest
    intermediate.  Returns one of 'fuse_q_qkt' | 'fuse_pv' | 'lbl'.

    In LLM attention M = sequence length and N = head dim, so M >> N and
    the M>N schedule — never materialise the M x M score matrix — is
    selected; it lowers to the flash-style fused attention kernel
    (kernels/fused_attention.py).  M < N selects Q-projection fusion
    (kernels/fused_qproj_attention.py).  M == N has no memory gain
    (Eq. 6/9) and keeps the unfused path.
    """
    if M > N:
        return "fuse_pv"
    if M < N:
        return "fuse_q_qkt"
    return "lbl"


def predicted_alpha(M: int, N: int) -> float:
    """alpha for the selected schedule (== analytical.alpha)."""
    return analytical.alpha(M, N)


# ---------------------------------------------------------------------------
# Phase-aware (prefill vs decode) whole-network schedule selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhasePlan:
    """The Fig. 6 decision rule generalized to inference phases at
    network scale: which intermediates to fuse through in every block,
    the predicted memory gain, and the assembled network schedule.

    Units: ``alpha`` is the predicted A_fused / A_LBL ratio (< 1 means
    fusion shrinks the active-feature peak); ``score_cols`` is C, the
    width of each head's score matrix (M for prefill self-attention,
    n_ctx for KV-cached decode).
    """

    phase: str                  # "prefill" | "decode"
    M: int                      # query rows per block
    score_cols: int             # score-matrix width C
    head_dim: int               # N
    fuse_q: bool                # stream Q into QK^T
    fuse_scores: bool           # stream QK^T -> softmax -> .V
    policy: str                 # named preset the flags correspond to
    alpha: float                # predicted memory gain of the choice
    workload: wl.Workload       # the n-block network
    schedule: sch.Schedule      # the assembled network schedule
    fuse_block: bool = False    # decode megakernel: heads + output
    #                             projection + residual in ONE stage

    def evaluate(self, accel: Optional[Accelerator] = None,
                 row_block: Optional[int] = None) -> sch.Result:
        """Engine-execute the assembled schedule — the predicted
        cycles/peak the lowering subsystem's validation harness
        (tools/validate_costmodel.py) compares measured runs against."""
        accel = accel or pe_array_64x64()
        if row_block is None:
            rows = max(l.rows for l in self.workload.layers.values())
            row_block = max(1, rows // 64)
        return sch.evaluate(self.workload, accel, self.schedule,
                            row_block=row_block)

    def __repr__(self) -> str:
        return (f"<PhasePlan {self.phase} policy={self.policy} "
                f"M={self.M} C={self.score_cols} N={self.head_dim} "
                f"alpha={self.alpha:.3f} "
                f"schedule={self.schedule.name!r}>")


def phase_policy(phase: str, M: int, score_cols: int,
                 head_dim: int) -> tuple[bool, bool]:
    """(fuse_q, fuse_scores) per the generalized decision rule.

    Prefill (C == M) reduces exactly to the paper's Sec. IV.C.3 rule:
    fuse through the largest intermediate — Q->QK^T for M < N, the
    score pipeline for M > N, neither at M == N (Eq. 6: no gain).

    Decode moves the crossover: cached K/V leave active memory, so
    streaming Q into QK^T is always free gain (the projections drain
    the input in place), and score fusion pays exactly when
    ``alpha_kv < 1``, i.e. C > 2N (analytical.alpha_kv).
    """
    if phase == "prefill":
        sel = select_schedule(M, head_dim)
        return sel == "fuse_q_qkt", sel == "fuse_pv"
    if phase == "decode":
        return True, analytical.alpha_kv(M, score_cols, head_dim) < 1.0
    raise ValueError(f"unknown phase {phase!r}")


def _phase_block_stages(prefix: str, n_heads: int, n_kv_heads: int,
                        mlp: str, norm: str,
                        fuse_q: bool, fuse_scores: bool,
                        core: int = 0,
                        fuse_block: bool = False) -> list[sch.Stage]:
    """Stages of one network block under the chosen fusion flags.
    Layer names follow ``workload._add_transformer_block``; the FFN and
    norms run layer-by-layer (their intermediates are the block's
    smallest).  ``fuse_block`` assembles the decode megakernel stage:
    every head chain, the per-head output projections, their
    accumulation and the residual add in ONE stage with every internal
    edge streamed (the engine model of
    ``kernels/fused_decode_block.py``)."""
    p = prefix

    def stage(*layers, streamed=()):
        return sch.Stage(layers=tuple(layers),
                         streamed=frozenset(streamed), core=core)

    out: list[sch.Stage] = []
    if norm == "pre":
        out.append(stage(f"{p}ln1"))
    for g in range(n_kv_heads):
        out.append(stage(f"{p}kv{g}.K"))
        out.append(stage(f"{p}kv{g}.V"))
    if fuse_block:
        # layer order mirrors the workload builder's insertion order
        # (all head chains, then proj0, proj1, acc1, proj2, acc2, ...)
        layers: list[str] = []
        edges: set[tuple[str, str]] = set()
        for h in range(n_heads):
            q, qkt = f"{p}h{h}.Q", f"{p}h{h}.QKT"
            sm, av = f"{p}h{h}.SM", f"{p}h{h}.AV"
            layers += [q, qkt, sm, av]
            edges |= {(q, qkt), (qkt, sm), (sm, av)}
        prev = None
        for h in range(n_heads):
            proj = f"{p}proj{h}"
            layers.append(proj)
            edges.add((f"{p}h{h}.AV", proj))
            if prev is None:
                prev = proj
            else:
                acc = f"{p}acc{h}"
                layers.append(acc)
                edges |= {(prev, acc), (proj, acc)}
                prev = acc
        layers.append(f"{p}res1")
        edges.add((prev, f"{p}res1"))
        out.append(stage(*layers, streamed=edges))
    else:
        for h in range(n_heads):
            q, qkt = f"{p}h{h}.Q", f"{p}h{h}.QKT"
            sm, av = f"{p}h{h}.SM", f"{p}h{h}.AV"
            head = [q, qkt, sm, av]
            edges = set()
            if fuse_q:
                edges.add((q, qkt))
            if fuse_scores:
                edges.update({(qkt, sm), (sm, av)})
            # split the head chain into contiguous fused runs
            cur = [head[0]]
            for a, b in zip(head, head[1:]):
                if (a, b) in edges:
                    cur.append(b)
                else:
                    out.append(stage(*cur, streamed={e for e in edges
                                                     if e[1] in cur}))
                    cur = [b]
            out.append(stage(*cur, streamed={e for e in edges
                                             if e[1] in cur}))
            out.append(stage(f"{p}proj{h}"))
            if h > 0:
                out.append(stage(f"{p}acc{h}"))
        out.append(stage(f"{p}res1"))
    out.append(stage(f"{p}ln2" if norm == "pre" else f"{p}ln1"))
    if mlp == "silu_glu":
        ffn = ["gate", "up", "act", "mul", "down"]
    elif mlp == "gelu":
        ffn = ["up", "act", "down"]
    else:   # keep in lockstep with workload._add_ffn
        raise ValueError(f"unknown ffn kind {mlp!r}")
    for l in ffn:
        out.append(stage(f"{p}{l}"))
    out.append(stage(f"{p}res2"))
    if norm == "post":
        out.append(stage(f"{p}ln2"))
    return out


def phase_schedule(config, phase: str, seq_len: int, *,
                   decode_tokens: int = 1, n_blocks: int = 1,
                   norm: str = "pre", layer_index: int = 0,
                   fuse_q: Optional[bool] = None,
                   fuse_scores: Optional[bool] = None,
                   fuse_block: Optional[bool] = None) -> PhasePlan:
    """Select and assemble the phase-aware whole-network schedule for
    ``config`` (a ModelConfig-like object, see
    ``workload.from_model_config``).

    Args:
        config:        architecture dims (duck-typed; any of
                       ``repro_torch.configs.ARCHS``).
        phase:         "prefill" — ``seq_len`` is the prompt length M;
                       "decode" — ``seq_len`` is the context depth
                       n_ctx and ``decode_tokens`` (default 1) is M.
        n_blocks:      how many blocks of the network to stitch.
        fuse_q / fuse_scores: override the decision rule's fusion
                       flags (e.g. to build a counterfactual
                       prefill-style schedule for a decode workload,
                       as benchmarks/phase_sweep.py does).

    Returns a :class:`PhasePlan` whose ``schedule`` applies the same
    per-head fusion decision in every block (identical blocks,
    identical decisions) and whose ``alpha`` predicts the
    active-feature gain per head (``analytical.alpha`` for prefill,
    ``analytical.alpha_kv`` for decode).
    """
    dims = wl._config_dims(config, layer_index)
    if phase == "prefill":
        M, n_ctx = seq_len, 0
        score_cols = M
        alpha = analytical.alpha(M, dims["d_head"])
    elif phase == "decode":
        M, n_ctx = decode_tokens, seq_len
        score_cols = n_ctx
        alpha = analytical.alpha_kv(M, n_ctx, dims["d_head"])
    else:
        raise ValueError(f"unknown phase {phase!r}")
    rule_q, rule_scores = phase_policy(phase, M, score_cols,
                                       dims["d_head"])
    fuse_q = rule_q if fuse_q is None else fuse_q
    fuse_scores = rule_scores if fuse_scores is None else fuse_scores
    if fuse_block is None:
        # the megakernel is the M=1 decode endpoint of the fusion
        # ladder: it only exists past the alpha_kv crossover (both
        # fusion flags on) and for single-token steps, where the whole
        # attention sub-block collapses to one streamed row
        fuse_block = (phase == "decode" and M == 1
                      and fuse_q and fuse_scores)
    if fuse_block and not (fuse_q and fuse_scores):
        raise ValueError("fuse_block requires fuse_q and fuse_scores: "
                         "the megakernel subsumes both fusions")
    net = wl.network(config, n_blocks, phase=phase, seq_len=M,
                     n_ctx=n_ctx, norm=norm, layer_index=layer_index)
    stages: list[sch.Stage] = []
    for p in net.period_prefixes:
        stages.extend(_phase_block_stages(
            p, dims["n_heads"], dims["n_kv_heads"], dims["mlp"], norm,
            fuse_q, fuse_scores, fuse_block=fuse_block))
    policy = "megakernel" if fuse_block else \
        {(False, False): "lbl", (True, False): "fuse_q_qkt",
         (False, True): "fuse_pv", (True, True): "fuse_all"}[
            (fuse_q, fuse_scores)]
    schedule = sch.Schedule(
        name=f"phase[{phase}:{policy}]x{n_blocks}", stages=tuple(stages))
    # the stage assembly mirrors workload's builder names; a desync
    # (renamed layer, new FFN kind) must fail loudly here, not as an
    # opaque engine deadlock later
    from repro_torch.core import validation
    problems = validation.validate_schedule(net, schedule)
    if problems:
        raise sch.IllegalSchedule(
            f"phase_schedule assembly out of sync with workload "
            f"builders: {problems[:3]}")
    return PhasePlan(phase=phase, M=M, score_cols=score_cols,
                     head_dim=dims["d_head"], fuse_q=fuse_q,
                     fuse_scores=fuse_scores, policy=policy,
                     alpha=alpha, workload=net, schedule=schedule,
                     fuse_block=fuse_block)
