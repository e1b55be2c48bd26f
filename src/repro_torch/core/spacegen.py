"""Generic schedule-space generation for arbitrary ``Workload`` DAGs.

The seed explorer searched a hand-enumerated list of schedules for the
single attention head of the paper's Fig. 5.  This module generates the
legal (topological ordering x fusion-group cut x core placement) space
for *any* workload graph — full transformer blocks from the model zoo
included — the way Stream (arXiv 2212.10612) derives its scheduling
space from the layer DAG instead of from a template:

1. **Fusion cuts.**  ``streamable_edges`` finds every producer->consumer
   edge that is legal to layer-fuse: the consumer reads the producer
   row-aligned (MatMul I1, Softmax/LayerNorm/Elementwise sources — the
   paper's Sec. II.C dependency rules), both tensors have the same row
   count, and the consumer is the producer's *sole* real consumer, so
   the fused tensor never needs to hit L1.  Greedy chain decomposition
   turns those edges into disjoint linear chains; a *cut* selects a
   subset of edge *signatures* to fuse, so structurally identical
   positions (e.g. the per-head score pipelines of a multi-head block)
   always receive the same decision — symmetry breaking that collapses
   the exponential per-head choice into one.

2. **Orderings.**  For each cut the fused groups form a contracted DAG
   (contraction along sole-consumer chains cannot create cycles);
   linear extensions are enumerated depth-first with
   Weisfeiler-Lehman-style structural colors so permutations of
   interchangeable groups (identical heads) are visited once, capped at
   ``max_orderings``.

3. **Placements.**  Each ordering is mapped onto the platform's cores:
   everything on core 0; weakly-connected components (independent
   heads) round-robin across cores; a macs-balanced contiguous
   pipeline split of the ordering; and — when an ``Accelerator`` is
   passed and it mixes core types — a type-aware split that sends
   vector-dominated groups (softmax, norms) to the widest-SIMD core
   and matmul-dominated groups to the highest-throughput array.

Pruning keeps block-sized graphs tractable: besides the symmetry
breaking and the per-axis caps, when the assembled space still exceeds
``max_candidates`` the candidates are ranked by cheap bounds — a
whole-tensor stage-order liveness proxy for peak memory and the
busiest core's compute work for latency.  The bound-Pareto frontier
always survives (dominated candidates are dropped first); the rest of
the budget is filled round-robin across fusion cuts so the proxy's
blind spots never eliminate a whole region of the space before the
engine prices it exactly.

``chain_schedule`` is the shared assembly helper the named presets in
``core/fusion.py`` (lbl / fuse_q_qkt / fuse_pv / fuse_all) are thin
wrappers over, so hand-written and generated schedules are built by the
same machinery.

A copy of the JAX package's ``repro/core/spacegen.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence

from repro_torch.core import dependencies as deps
from repro_torch.core import scheduler as sch
from repro_torch.core import workload as wl

__all__ = [
    "SpaceOptions", "block_subworkload", "chain_schedule", "generate",
    "streamable_edges", "fusion_chains", "stage_peak_bound",
    "core_work_bound",
]


@dataclasses.dataclass(frozen=True)
class SpaceOptions:
    """Knobs bounding the generated space.  Defaults keep a full
    transformer block (hundreds of layers) in the low hundreds of
    candidates.

    ``periodic`` enables block-periodic symmetry on workloads built by
    ``workload.network``: one block's sub-space is explored and
    replicated across all blocks instead of re-enumerating every block
    (network-scale spaces stay block-sized).  ``inter_block`` selects
    the network-level placement axes: ``"df"`` (depth-first — every
    block on the same cores as the sub-schedule, weights reload as the
    cores move from block to block) and ``"bp"`` (block-pipelined —
    block b's stages shift to core (c + b) % n_cores, weights stay
    resident per core and activations cross the link at each block
    boundary)."""

    max_orderings: int = 12       # linear extensions per fusion cut
    max_cuts: int = 48            # fusion-cut combinations
    max_candidates: int = 256     # total schedules after pruning
    placements: tuple[str, ...] = ("c0", "rr", "pipeline", "hetero")
    periodic: bool = True         # reuse one block's sub-space
    inter_block: tuple[str, ...] = ("df", "bp")


# ---------------------------------------------------------------------------
# Graph helpers
# ---------------------------------------------------------------------------

# view resolution is shared with the engine: dependencies.is_view /
# real_producers / real_consumers keep the generator's streamability
# analysis in lockstep with the executor's dependency resolution
_is_view = deps.is_view
_real_deps = deps.real_producers
_real_consumers = deps.real_consumers


def _layer_sig(layer: wl.Layer) -> tuple:
    """Structural signature ignoring the layer's name."""
    return (type(layer).__name__, layer.rows, layer.cols,
            getattr(layer, "s", 0),
            getattr(layer, "materialize", None),
            getattr(layer, "ops_per_element", None))


# ---------------------------------------------------------------------------
# Step 1: streamable edges and fusion chains
# ---------------------------------------------------------------------------

def streamable_edges(workload: wl.Workload) -> frozenset:
    """(producer, consumer) layer pairs that may be layer-fused: the
    consumer reads the producer row-aligned, row counts match, and the
    consumer is the producer's sole real consumer (so the fused tensor
    never occupies L1 — the condition behind the paper's Fig. 5b/5c
    schedules)."""
    out = set()
    for layer in workload.topo_order():
        if _is_view(layer) or layer.rows < 1:
            continue
        for req in deps.required_inputs(workload, layer.name, 0, 1):
            p = req.producer
            if p == wl.INPUT or req.region == deps.ALL:
                continue
            producer = workload.layers[p]
            if producer.rows != layer.rows:
                continue
            if p in workload.outputs:
                continue
            if _real_consumers(workload, p) != [layer.name]:
                continue
            out.add((p, layer.name))
    return frozenset(out)


def fusion_chains(workload: wl.Workload) -> list:
    """Greedy decomposition of the streamable edges into disjoint linear
    chains (each layer at most one fused-in and one fused-out edge),
    deterministic in topological order.  Returns a list of chains, each
    a list of (producer, consumer) edges."""
    topo_idx = {l.name: i for i, l in enumerate(workload.topo_order())}
    edges = sorted(streamable_edges(workload),
                   key=lambda e: (topo_idx[e[0]], topo_idx[e[1]]))
    nxt: dict[str, str] = {}
    prev: dict[str, str] = {}
    for a, b in edges:
        if a in nxt or b in prev:
            continue
        nxt[a] = b
        prev[b] = a
    chains = []
    for head in sorted(nxt, key=topo_idx.get):
        if head in prev:
            continue
        chain = []
        cur = head
        while cur in nxt:
            chain.append((cur, nxt[cur]))
            cur = nxt[cur]
        chains.append(chain)
    return chains


def _cuts(workload: wl.Workload, options: SpaceOptions) -> list:
    """Enumerate fusion cuts as subsets of *edge signatures*: a cut
    fuses every chain edge whose (producer sig, consumer sig) pair is
    selected, so structurally identical positions — the score pipeline
    of every head, each accumulator link — always receive the same
    decision (symmetry breaking over identical heads).

    Candidate signature subsets, in order: nothing, everything, then
    every contiguous window of every distinct chain's signature
    sequence (fusion means contiguous segments; short windows first so
    the cap keeps the single-edge and Fig.-5-style segment fusions),
    then pairwise window unions.  Returns frozensets of fused edges.
    """
    chains = fusion_chains(workload)
    if not chains:
        return [frozenset()]

    def esig(e):
        return (_layer_sig(workload.layers[e[0]]),
                _layer_sig(workload.layers[e[1]]))

    all_edges = [e for ch in chains for e in ch]
    seqs: list = []
    seen_seq = set()
    for ch in chains:
        s = tuple(esig(e) for e in ch)
        if s not in seen_seq:
            seen_seq.add(s)
            seqs.append(s)
    windows: list = []
    seen_w = set()
    for qi, s in enumerate(seqs):
        for ln in range(1, len(s) + 1):
            for st in range(len(s) - ln + 1):
                w = frozenset(s[st:st + ln])
                if w not in seen_w:
                    seen_w.add(w)
                    windows.append((ln, qi, st, w))
    windows.sort(key=lambda t: (t[0], t[1], t[2]))
    window_sets = [w for _, _, _, w in windows]
    full_sig = frozenset(sig for s in seqs for sig in s)
    sig_subsets = [frozenset(), full_sig] + window_sets \
        + [a | b for a, b in
           itertools.islice(itertools.combinations(window_sets, 2),
                            4 * options.max_cuts)]

    cuts: list = []
    seen = set()
    for subset in sig_subsets:
        key = frozenset(e for e in all_edges if esig(e) in subset)
        if key in seen:
            continue
        seen.add(key)
        cuts.append(key)
        if len(cuts) >= options.max_cuts:
            break
    # the maximal fusion is the paper's most interesting corner: make
    # sure the cap never drops it
    full = frozenset(all_edges)
    if full not in seen:
        cuts.append(full)
    return cuts


# ---------------------------------------------------------------------------
# Step 2: fused groups and ordering enumeration
# ---------------------------------------------------------------------------

def _build_groups(workload: wl.Workload, fused: frozenset):
    """Collapse fused edges into groups.  Returns (groups, group_of,
    group_deps): ``groups`` maps group id -> ordered member tuple;
    ``group_deps`` maps group id -> set of predecessor group ids."""
    nxt = dict(fused)
    prev = {b: a for a, b in fused}
    group_of: dict[str, int] = {}
    groups: dict[int, tuple] = {}
    gid = 0
    for layer in workload.topo_order():
        name = layer.name
        if _is_view(layer) or name in group_of:
            continue
        if name in prev:      # chain member handled from its head
            continue
        members = [name]
        cur = name
        while cur in nxt:
            cur = nxt[cur]
            members.append(cur)
        for m in members:
            group_of[m] = gid
        groups[gid] = tuple(members)
        gid += 1
    group_deps: dict[int, set] = {g: set() for g in groups}
    for g, members in groups.items():
        for m in members:
            for p in _real_deps(workload, m):
                pg = group_of[p]
                if pg != g:
                    group_deps[g].add(pg)
    return groups, group_of, group_deps


def _wl_colors(groups: dict, group_deps: dict,
               init: dict) -> dict:
    """Weisfeiler-Lehman color refinement over the group DAG: groups
    with the same color are structurally interchangeable (identical
    heads), so ordering enumeration branches on one representative."""
    succs: dict[int, list] = {g: [] for g in groups}
    for g, ps in group_deps.items():
        for p in ps:
            succs[p].append(g)
    colors = dict(init)
    n = len(set(colors.values()))
    for _ in range(len(groups)):
        interned: dict[tuple, int] = {}
        new = {}
        for g in groups:
            key = (colors[g],
                   tuple(sorted(colors[p] for p in group_deps[g])),
                   tuple(sorted(colors[s] for s in succs[g])))
            new[g] = interned.setdefault(key, len(interned))
        colors = new
        n2 = len(set(colors.values()))
        if n2 == n:
            break
        n = n2
    return colors


def _orderings(groups: dict, group_deps: dict, colors: dict,
               limit: int) -> list:
    """Up to ``limit`` linear extensions of the group DAG, depth-first
    with deterministic smallest-id-first choice; among simultaneously
    ready groups only one per structural color is expanded.  Iterative
    (explicit frame stack) so thousand-group DAGs — e.g. the empty cut
    of a deep layer chain — stay clear of the recursion limit."""
    indeg = {g: len(ps) for g, ps in group_deps.items()}
    succs: dict[int, list] = {g: [] for g in groups}
    for g, ps in group_deps.items():
        for p in ps:
            succs[p].append(g)
    results: list = []
    order: list = []
    # frame: [ready, next candidate index, colors branched on, the
    # choice applied when the child frame below was pushed (or None)]
    frames: list = [[sorted(g for g, d in indeg.items() if d == 0),
                     0, set(), None]]
    while frames and len(results) < limit:
        frame = frames[-1]
        ready = frame[0]
        if frame[3] is not None:          # child returned: undo choice
            undone = frame[3]
            for s in succs[undone]:
                indeg[s] += 1
            order.pop()
            frame[3] = None
        if not ready:
            if len(order) == len(groups):
                results.append(tuple(order))
            frames.pop()
            continue
        i = frame[1]
        while i < len(ready) and colors[ready[i]] in frame[2]:
            i += 1
        if i >= len(ready):
            frames.pop()
            continue
        frame[1] = i + 1
        g = ready[i]
        frame[2].add(colors[g])
        order.append(g)
        opened = []
        for s in succs[g]:
            indeg[s] -= 1
            if indeg[s] == 0:
                opened.append(s)
        frame[3] = g
        frames.append([sorted([r for r in ready if r != g] + opened),
                       0, set(), None])
    return results


# ---------------------------------------------------------------------------
# Step 3: core placements
# ---------------------------------------------------------------------------

def _components(groups: dict, group_deps: dict) -> dict:
    """Weakly-connected component id per group (independent subgraphs,
    e.g. parallel attention heads)."""
    parent = {g: g for g in groups}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for g, ps in group_deps.items():
        for p in ps:
            parent[find(g)] = find(p)
    comp_ids: dict[int, int] = {}
    out = {}
    for g in sorted(groups):
        root = find(g)
        out[g] = comp_ids.setdefault(root, len(comp_ids))
    return out


def _placements(workload: wl.Workload, groups: dict, group_deps: dict,
                order: tuple, n_cores: int,
                wanted: Sequence[str], accel=None) -> list:
    """(tag, group id -> core) placements for one ordering."""
    out = [("c0", {g: 0 for g in groups})] if "c0" in wanted else []
    if n_cores <= 1:
        return out or [("c0", {g: 0 for g in groups})]
    if "hetero" in wanted and accel is not None and accel.n_cores > 1:
        from repro_torch.core import accelerator as _acc
        if _acc.is_heterogeneous(accel):
            simd_best = _acc.widest_simd_core(accel)
            mac_best = _acc.widest_array_core(accel)
            if simd_best is not None and simd_best != mac_best:
                placement = {}
                for g in groups:
                    vec = sum(workload.layers[m].vector_ops()
                              for m in groups[g])
                    mac = sum(workload.layers[m].macs()
                              for m in groups[g])
                    core = simd_best if vec > mac else mac_best
                    # a group with any vector work is only legal on a
                    # core with a SIMD unit
                    if vec and accel.cores[core].simd is None:
                        core = simd_best
                    placement[g] = core
                if len(set(placement.values())) > 1:
                    out.append(("het", placement))
    if "rr" in wanted:
        comp = _components(groups, group_deps)
        if len(set(comp.values())) > 1:
            out.append(("rr", {g: comp[g] % n_cores for g in groups}))
    if "pipeline" in wanted and len(order) >= n_cores:
        work = {g: sum(workload.layers[m].macs()
                       + workload.layers[m].vector_ops()
                       for m in groups[g]) for g in groups}
        total = sum(work.values()) or 1
        placement, acc, core = {}, 0, 0
        for g in order:
            placement[g] = core
            acc += work[g]
            if acc >= total * (core + 1) / n_cores and core < n_cores - 1:
                core += 1
        if len(set(placement.values())) > 1:
            out.append(("pipe", placement))
    return out


# ---------------------------------------------------------------------------
# Schedule assembly
# ---------------------------------------------------------------------------

def _stages(groups: dict, order: tuple, fused: frozenset,
            core_of: dict) -> tuple:
    stages = []
    for g in order:
        members = groups[g]
        streamed = frozenset((a, b) for a, b in zip(members, members[1:]))
        assert streamed <= fused or not streamed
        stages.append(sch.Stage(layers=members, streamed=streamed,
                                core=core_of[g]))
    return tuple(stages)


def chain_schedule(name: str, order: Sequence[str],
                   fused: Iterable = (), core: int = 0) -> sch.Schedule:
    """Assemble a single-core ``Schedule`` from a layer-name ordering
    and a set of fused (producer, consumer) edges.  Fused edges must
    connect names adjacent in ``order`` (they collapse into one
    row-interleaved stage); the named presets in ``core/fusion.py`` are
    thin wrappers over this."""
    fused = frozenset(fused)
    stages: list = []
    cur: list[str] = []
    for name_ in order:
        if cur and (cur[-1], name_) in fused:
            cur.append(name_)
        else:
            if cur:
                stages.append(cur)
            cur = [name_]
    if cur:
        stages.append(cur)
    placed = set()
    built = []
    for members in stages:
        streamed = frozenset(e for e in zip(members, members[1:])
                             if e in fused)
        placed |= streamed
        built.append(sch.Stage(layers=tuple(members), streamed=streamed,
                               core=core))
    if placed != fused:
        raise ValueError(
            f"fused edges {sorted(fused - placed)} do not connect "
            "adjacent entries of the ordering")
    return sch.Schedule(name=name, stages=tuple(built))


# ---------------------------------------------------------------------------
# Cheap bounds used for dominance pruning
# ---------------------------------------------------------------------------

def stage_peak_bound(workload: wl.Workload, schedule: sch.Schedule) -> int:
    """Whole-tensor liveness proxy for peak active memory: walk the
    stage list in order, allocate each non-streamed output at its
    stage, free it after its last consuming stage.  Ignores row-level
    substitution, so it upper-bounds the engine's row-exact peak —
    cheap enough to rank thousands of candidates."""
    streamed = sch._streamed_tensors(workload, schedule)
    stage_of: dict[str, int] = {}
    for i, st in enumerate(schedule.stages):
        for l in st.layers:
            stage_of.setdefault(l, i)
    last_use: dict[str, int] = {}
    for i, st in enumerate(schedule.stages):
        for l in st.layers:
            for p in _real_deps(workload, l):
                last_use[p] = max(last_use.get(p, -1), i)
    active = workload.input_words
    peak = active
    frees: dict[int, int] = {}
    for i, st in enumerate(schedule.stages):
        for l in st.layers:
            if l in streamed or l in workload.cache_layers:
                continue        # never hits L1 / persistent KV cache
            words = workload.layers[l].out_words
            active += words
            keep = l in workload.outputs or l not in last_use
            if not keep:
                frees[last_use[l]] = frees.get(last_use[l], 0) + words
        peak = max(peak, active)
        active -= frees.pop(i, 0)
    return peak


def core_work_bound(workload: wl.Workload, schedule: sch.Schedule) -> int:
    """Latency proxy: compute work (macs + vector ops) of the busiest
    core.  Communication-free, so it lower-bounds nothing exactly —
    it is a ranking signal, not a guarantee."""
    per_core: dict[int, int] = {}
    for st in schedule.stages:
        for l in st.layers:
            layer = workload.layers[l]
            per_core[st.core] = per_core.get(st.core, 0) \
                + layer.macs() + layer.vector_ops()
    return max(per_core.values(), default=0)


def _prune(workload: wl.Workload, tagged: list, cap: int) -> list:
    """Prune ``tagged`` [((cut index, placement tag), schedule), ...]
    to ``cap``:

    1. keep the (peak bound, work bound) Pareto frontier — dominated
       candidates go last;
    2. fill the remaining budget round-robin across (fusion cut,
       placement) strata (each stratum's survivors ranked by bounds),
       so the cheap proxy — which systematically over-rewards
       aggressive fusion and multi-core spreading because it cannot
       see row-level substitution or communication — never starves
       whole regions of the space before the engine prices them
       exactly.
    """
    if len(tagged) <= cap:
        return [s for _, s in tagged]
    scored = sorted(
        ((stage_peak_bound(workload, s), core_work_bound(workload, s),
          ci, i, s) for i, (ci, s) in enumerate(tagged)),
        key=lambda t: (t[0], t[1], t[3]))
    keep: list = []
    chosen: set = set()
    best_work = None
    for peak, work, ci, i, s in scored:      # bound-Pareto frontier
        if best_work is None or work < best_work:
            best_work = work
            keep.append((i, s))
            chosen.add(i)
    strata: dict[int, list] = {}
    for peak, work, ci, i, s in scored:
        if i not in chosen:
            strata.setdefault(ci, []).append((i, s))
    while len(keep) < cap and strata:
        for ci in sorted(strata):
            if strata[ci]:
                keep.append(strata[ci].pop(0))
                if len(keep) >= cap:
                    break
        strata = {k: v for k, v in strata.items() if v}
    keep.sort()                              # restore generation order
    return [s for _, s in keep[:max(cap, 1)]]


# ---------------------------------------------------------------------------
# Block-periodic networks: explore one block, replicate across blocks
# ---------------------------------------------------------------------------

def block_subworkload(net: wl.Workload) -> wl.Workload:
    """Extract the first block of a block-periodic network (built by
    ``workload.network``) as a standalone workload: block-0 layers
    only, with the block's boundary layer (the one the next block
    consumes) as the output."""
    if not net.period_prefixes:
        raise ValueError(f"{net.name} is not block-periodic")
    p0 = net.period_prefixes[0]
    block0 = {n for n, b in net.block_of.items() if b == 0}
    sub = wl.Workload(name=f"{net.name}[{p0}]",
                      input_rows=net.input_rows,
                      input_cols=net.input_cols)
    boundary = None
    for layer in net.topo_order():
        if layer.name not in block0:
            continue
        sub.add(layer)
        if any(c not in block0 for c in net._consumer_names
               .get(layer.name, ())):
            boundary = layer.name
    if boundary is None:   # single-block network: its outputs stand
        sub.outputs = net.outputs
    else:
        sub.outputs = (boundary,)
    sub.cache_layers = net.cache_layers & block0
    sub.kv_cache_words = net.kv_cache_words // max(net.n_blocks, 1)
    return sub


def _rename_stage(stage: sch.Stage, old: str, new: str,
                  core: int) -> sch.Stage:
    """Re-prefix a block-0 stage onto block ``new`` and core ``core``."""

    def ren(n: str) -> str:
        return new + n[len(old):] if n.startswith(old) else n

    return sch.Stage(
        layers=tuple(ren(n) for n in stage.layers),
        streamed=frozenset((ren(a), ren(b)) for a, b in stage.streamed),
        core=core)


def _generate_periodic(net: wl.Workload, n_cores: int,
                       options: SpaceOptions, accel=None) -> list:
    """Block-periodic generation: enumerate the sub-space of block 0
    (cuts x orderings x placements) once, then replicate each
    sub-schedule across every block — identical blocks receive
    identical decisions, the inter-block axis chooses between
    depth-first residency ("df": same cores every block, weights
    reload at block switches) and block-pipelined residency ("bp":
    blocks round-robin over cores, weights stay resident, activations
    pay the link at each boundary).  Returns ``[(tag, schedule), ...]``
    for ``_prune``."""
    sub = block_subworkload(net)
    subspace = generate(sub, n_cores, dataclasses.replace(
        options, periodic=False), accel=accel)
    prefixes = net.period_prefixes
    p0 = prefixes[0]
    modes = [m for m in options.inter_block
             if m == "df" or n_cores > 1]
    out: list = []
    for si, subsched in enumerate(subspace):
        for mode in modes or ["df"]:
            stages: list = []
            for b, pb in enumerate(prefixes):
                shift = b if mode == "bp" else 0
                for st in subsched.stages:
                    stages.append(_rename_stage(
                        st, p0, pb, (st.core + shift) % n_cores))
            out.append(((si, mode), sch.Schedule(
                name=f"net{len(prefixes)}x[{subsched.name}]@{mode}",
                stages=tuple(stages))))
    return out


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def generate(workload: wl.Workload, n_cores: int = 1,
             options: Optional[SpaceOptions] = None,
             accel=None) -> list:
    """Enumerate legal schedules for ``workload`` over ``n_cores``
    cores: fusion cuts x topological orderings x core placements,
    symmetry-broken, capped and dominance-pruned per ``options``.
    ``accel`` (an ``Accelerator``) unlocks the type-aware "hetero"
    placement on platforms mixing core types.

    For block-periodic networks (``workload.period_prefixes`` set by
    ``workload.network``) with ``options.periodic`` (the default), one
    block's sub-space is generated and replicated across all blocks
    with the depth-first / block-pipelined inter-block axis — the
    network space stays the size of one block's space.

    Args:
        workload: any ``Workload`` DAG.
        n_cores:  cores of the target platform (placement axis).
        options:  a :class:`SpaceOptions`; defaults keep block-sized
                  graphs in the low hundreds of candidates.

    Returns a list of ``scheduler.Schedule`` ready for
    ``scheduler.evaluate``; the space provably contains the paper's
    hand-written attention-head schedules (pinned by
    tests/test_spacegen.py).

    >>> from repro_torch.core import workload as wl
    >>> head = wl.attention_head(8, 8)
    >>> scheds = generate(head, 1)
    >>> len(scheds) > 0
    True
    >>> sorted({st.core for s in scheds for st in s.stages})
    [0]
    """
    options = options or SpaceOptions()
    if options.periodic and len(workload.period_prefixes) > 1:
        return _prune(workload, _generate_periodic(
            workload, n_cores, options, accel), options.max_candidates)
    out: list = []        # ((cut index, placement tag), schedule)
    seen: set = set()
    for ci, fused in enumerate(_cuts(workload, options)):
        groups, group_of, group_deps = _build_groups(workload, fused)
        sigs = {g: tuple(_layer_sig(workload.layers[m])
                         for m in groups[g]) for g in groups}
        interned = {s: i for i, s in enumerate(sorted(set(sigs.values())))}
        init = {g: interned[sigs[g]] for g in groups}
        colors = _wl_colors(groups, group_deps, init)
        for oi, order in enumerate(_orderings(groups, group_deps, colors,
                                              options.max_orderings)):
            for tag, core_of in _placements(workload, groups, group_deps,
                                            order, n_cores,
                                            options.placements, accel):
                stages = _stages(groups, order, fused, core_of)
                if stages in seen:
                    continue
                seen.add(stages)
                out.append(((ci, tag), sch.Schedule(
                    name=f"gen[c{ci}.o{oi}]@{tag}", stages=stages)))
    return _prune(workload, out, options.max_candidates)
