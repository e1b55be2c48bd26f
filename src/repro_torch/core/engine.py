"""Event-driven Step-5 executor for multi-accelerator platforms.

The seed executor walked stages strictly in schedule-list order: a stage
could only consume tensors produced by *earlier list entries*, and
cross-core tensor movement was free.  This engine schedules every
stage's nodes against global time instead:

* each core owns an ordered queue of its stages (schedule order is
  preserved *per core* — that is what makes single-core results
  bit-identical to the seed model);
* at every step the engine picks, across all cores, the ready node with
  the earliest start on its (core, resource) timeline — cores therefore
  progress concurrently, and a stage may consume tensors produced by a
  stage that appears *later* in the schedule list on another core;
* a tensor consumed on a different core than it was produced on books
  an explicit transfer on the platform's ``Interconnect``
  (``core/interconnect.py``): per-link FIFO occupancy, latency that
  delays the consumer, pJ/word energy, and double-buffered occupancy in
  both cores' L1 accounting (the home copy stays until global row
  liveness frees it; the replica is freed when the last consumer node
  on the destination core completes);
* streamed edges may now cross stages *and cores* (declared on the
  consumer stage with the producer living elsewhere): producer rows are
  forwarded over the link as they complete, never touch the producer's
  L1, and occupy one double-buffered row-block on each side.

Per-node latency/energy comes from an injectable ``CostModel``
(``core/costmodel.py``); memory accounting preserves the Fig. 5
rank-0/rank-1 event semantics of the seed exactly.

Phase-aware accounting (decode / multi-block networks):

* KV-cache appends (``Workload.cache_layers``) never allocate L1 —
  the cache is persistent memory, globally visible once written
  (no cross-core replica transfers), reported as
  ``Result.kv_cache_words``;
* a core switching network blocks (``Workload.block_of``) refills the
  switched-to block's weights from off-chip: the switching node is
  delayed by ``block weight words / offchip_bandwidth`` cycles and
  the traffic/energy lands in ``Result.weight_reload_*``.  The first
  block a core touches is ambient (covered by the per-layer weight
  fetches of the cost model), so single-block results are
  bit-identical to the seed.

Transfers are modelled at consumer-node granularity: when a node needs
rows [0, b) of a remote tensor, only the not-yet-moved suffix crosses
the link, so row-pipelined cross-core streaming falls out naturally.
Producers are not back-pressured by slow consumers (the link's FIFO and
the double buffer absorb skew) — a deliberate simplification over a
full NoC simulation.

A copy of the JAX package's ``repro/core/engine.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import costmodel as cmod
from repro_torch.core import dependencies as deps
from repro_torch.core import nodes as cn
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import Accelerator
from repro_torch.core.costmodel import CostModel, IllegalSchedule
from repro_torch.core.interconnect import LinkTimeline


@dataclasses.dataclass
class _StageState:
    """Mutable progress of one stage in the per-core queue."""

    stage: object                 # scheduler.Stage
    idx: dict                     # layer -> next node index
    active: list                  # layers that actually produce nodes
    remaining: int


def execute(workload: wl.Workload, accel: Accelerator, schedule,
            row_block: int = 1,
            cost_model: Optional[CostModel] = None):
    """Run ``schedule`` on the analytical machine model, event-driven.

    Returns a ``scheduler.Result``; see ``scheduler.evaluate`` for the
    stable facade.
    """
    from repro_torch.core import scheduler as sch   # deferred: facade imports us

    cm = cost_model or cmod.DEFAULT
    split = cn.split_workload(workload, row_block)
    counts = deps.consumer_row_counts(workload, row_block)
    streamed_tensors = sch._streamed_tensors(workload, schedule)
    streamed_pairs = schedule.streamed_pairs()
    streamed_producers = {a for a, _ in streamed_pairs}
    # KV-cache appends: persistent (non-active) memory — never allocated
    # in L1, never freed, globally visible once written (the cache is a
    # shared store, so no cross-core replica transfers either)
    cache_set = workload.cache_layers

    # which core executes (and therefore "homes") each layer's output
    home_core: dict[str, int] = {}
    for st in schedule.stages:
        for lname in st.layers:
            home_core.setdefault(lname, st.core)

    # validate cross-stage streamed edges: declared on the consumer
    # stage, producer scheduled elsewhere — they must cross cores (the
    # register files the paper fuses through are per-core).
    for st in schedule.stages:
        for a, b in st.streamed:
            if b not in st.layers:
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}): consumer {b!r} not in "
                    f"stage {st.layers}")
            if a in st.layers:
                continue              # intra-stage edge, validated by Stage
            if a not in workload.layers:
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}): unknown producer {a!r}")
            if home_core.get(a) is None:
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}): producer {a!r} is not "
                    "scheduled by any stage")
            if home_core[a] == st.core:
                raise IllegalSchedule(
                    f"streamed edge ({a},{b}) crosses stages on core "
                    f"{st.core}; same-core fusion requires one stage")

    # completion time per (layer, node-index); row-prefix completion
    comp: dict[str, list] = {name: [] for name in split}

    # which cores replicate the network input
    input_cores = set()
    for st in schedule.stages:
        for lname in st.layers:
            first_rows = min(row_block, workload.layers[lname].rows)
            reqs = deps.required_inputs(workload, lname, 0, first_rows)
            if any(r.producer == wl.INPUT for r in reqs):
                input_cores.add(st.core)
    eff_input_cores = input_cores or {0}
    tensor_core: dict[str, int] = {}

    # (time, rank, core, delta_words); rank 0 = allocations + atomic
    # row-substitution frees, rank 1 = deferred end-of-tensor frees —
    # peaks are recorded between rank 0 and rank 1 of the same instant.
    events: list = []
    for c in sorted(eff_input_cores):
        events.append((0.0, 0, c, workload.input_words))

    # the input is preloaded into the lowest-numbered input core (seed
    # semantics); every other input core receives its replica over the
    # fabric before its first input-consuming node may start.  The
    # replica's occupancy stays booked from t=0 (the buffer is reserved),
    # matching the seed's Fig. 5 bookkeeping.
    links = LinkTimeline(accel.fabric())
    input_avail: dict[int, float] = {}
    primary_input = min(eff_input_cores)
    for c in sorted(eff_input_cores):
        if c == primary_input:
            input_avail[c] = 0.0
        else:
            tr = links.book(primary_input, c, wl.INPUT,
                            workload.input_words, 0.0)
            input_avail[c] = tr.end

    res_free: dict = {}
    rows_left = {t: list(cnt) for t, cnt in counts.items()}
    cols_of = {wl.INPUT: workload.input_cols}
    for l in workload.layers.values():
        cols_of[l.name] = l.cols

    # cross-core transfer state: (tensor, dst) -> monotone list of
    # (rows transferred up to, arrival time of that prefix)
    xfer_state: dict[tuple[str, int], list] = {}
    db_booked: set = set()     # streamed (tensor, dst) with buffer booked

    # remaining consumer nodes per (remote tensor, consuming core) —
    # when it hits zero the replica / double buffer is released.  The
    # network input is replicated per core, so its row liveness is also
    # tracked per core: each core's replica rows are freed by that
    # core's own consumers (for a single core this equals the seed's
    # global count).
    rem_remote: dict[tuple[str, int], int] = {}
    input_rows_left: dict[int, list[int]] = {
        c: [0] * workload.input_rows for c in eff_input_cores}
    for st in schedule.stages:
        for lname in st.layers:
            for node in split[lname]:
                for req in deps.required_inputs(workload, lname,
                                                node.row_start,
                                                node.row_end):
                    if req.producer == wl.INPUT:
                        rl = input_rows_left[st.core]
                        rng = range(len(rl)) if req.region == deps.ALL \
                            else range(req.region[0],
                                      min(req.region[1], len(rl)))
                        for i in rng:
                            rl[i] += 1
                        continue
                    if req.producer in cache_set:
                        continue
                    phome = home_core.get(req.producer)
                    if phome is not None and phome != st.core:
                        key = (req.producer, st.core)
                        rem_remote[key] = rem_remote.get(key, 0) + 1

    def _db_words(tensor: str) -> int:
        """Streamed cross-core edges hold a double-buffered row-block on
        each side of the link."""
        rows = min(row_block, workload.layers[tensor].rows)
        return 2 * rows * cols_of[tensor]

    def _arrival(producer: str, src: int, dst: int, need_row: int,
                 rows_ready: float, commit: bool, scratch: dict) -> float:
        """Time rows [0, need_row) of ``producer`` exist on ``dst``.

        Books the missing suffix on the link when ``commit``; otherwise
        sequences tentative transfers in ``scratch`` so a multi-operand
        preview sees consistent link occupancy.
        """
        state = xfer_state.get((producer, dst))
        if state and state[-1][0] >= need_row:
            for upto, arr in state:
                if upto >= need_row:
                    return arr
        moved_upto = state[-1][0] if state else 0
        words = (need_row - moved_upto) * cols_of[producer]
        if commit:
            tr = links.book(src, dst, producer, words, rows_ready)
            xfer_state.setdefault((producer, dst), []) \
                .append((need_row, tr.end))
            if producer in streamed_tensors:
                if (producer, dst) not in db_booked:
                    db_booked.add((producer, dst))
                    db = _db_words(producer)
                    events.append((tr.start, 0, src, db))
                    events.append((tr.start, 0, dst, db))
            else:
                # replica lands in the consumer's L1 on arrival
                events.append((tr.end, 0, dst, words))
            return tr.end
        key = links.fabric.link_key(src, dst)
        free = scratch.get(key, links.free_time(src, dst))
        start = max(free, rows_ready)
        end = start + links.fabric.transfer_cycles(words)
        scratch[key] = end
        return end

    def dep_ready_time(lname: str, a: int, b: int, core: int,
                       commit: bool = False) -> Optional[float]:
        """Completion-plus-arrival time after which rows [a,b) of every
        required input exist *on this core*; None if the schedule has
        not produced them yet.  ``commit`` books cross-core transfers."""
        t = 0.0
        scratch: dict = {}
        for req in deps.required_inputs(workload, lname, a, b):
            if req.producer == wl.INPUT:
                avail = input_avail.get(core, 0.0)
                if avail > t:
                    t = avail
                continue
            pnodes = split[req.producer]
            if not pnodes:   # view with no nodes: resolved already
                continue
            need_row = (pnodes[-1].row_end if req.region == deps.ALL
                        else req.region[1])
            done = comp[req.producer]
            # nodes complete in row order; find first node covering
            # need_row-1
            covered = 0
            for k, nd in enumerate(pnodes):
                if nd.row_end >= need_row:
                    covered = k + 1
                    break
            if len(done) < covered:
                return None
            ready = done[covered - 1]
            phome = home_core.get(req.producer)
            if phome is not None and phome != core \
                    and req.producer not in cache_set:
                ready = _arrival(req.producer, phome, core, need_row,
                                 ready, commit, scratch)
            t = max(t, ready)
        return t

    def apply_completion(node: cn.ComputationNode, core: int, t: float):
        layer = workload.layers[node.layer]
        if node.layer not in streamed_tensors \
                and node.layer not in cache_set:
            tensor_core.setdefault(node.layer, core)
            events.append((t, 0, core, node.n_rows * layer.cols))
        # release rows of inputs
        for req in deps.required_inputs(workload, node.layer,
                                        node.row_start, node.row_end):
            if req.producer in cache_set:
                continue       # cache contents are persistent: no frees
            # remote replica / stream-buffer countdown
            if req.producer != wl.INPUT:
                phome = home_core.get(req.producer)
                if phome is not None and phome != core:
                    key = (req.producer, core)
                    rem_remote[key] -= 1
                    if rem_remote[key] == 0:
                        state = xfer_state.get(key)
                        if req.producer in streamed_tensors:
                            if key in db_booked:
                                db = _db_words(req.producer)
                                events.append((t, 1, phome, -db))
                                events.append((t, 1, core, -db))
                        elif state:
                            moved = state[-1][0] * cols_of[req.producer]
                            events.append((t, 1, core, -moved))
            if req.producer in streamed_tensors:
                continue
            rank = 1 if req.region == deps.ALL else 0
            rl = input_rows_left[core] if req.producer == wl.INPUT \
                else rows_left[req.producer]
            rng = range(len(rl)) if req.region == deps.ALL else \
                range(req.region[0], min(req.region[1], len(rl)))
            freed = 0
            for i in rng:
                rl[i] -= 1
                if rl[i] == 0:
                    freed += 1
            if freed:
                cols = cols_of[req.producer]
                if req.producer == wl.INPUT:
                    # this core's replica only; other cores free theirs
                    # when their own consumers finish
                    events.append((t, rank, core, -freed * cols))
                else:
                    events.append((t, rank,
                                   tensor_core.get(req.producer, core),
                                   -freed * cols))

    # ---------------- per-core stage queues + the global commit loop
    core_list = sorted({st.core for st in schedule.stages})
    core_stages: dict[int, list[_StageState]] = {c: [] for c in core_list}
    total_remaining = 0
    for st in schedule.stages:
        active = [l for l in st.layers if split[l]]
        remaining = sum(len(split[l]) for l in active)
        core_stages[st.core].append(_StageState(
            stage=st, idx={l: 0 for l in st.layers}, active=active,
            remaining=remaining))
        total_remaining += remaining
    cur = {c: 0 for c in core_list}

    # per-(core, block) weight words: what a core must (re)load when it
    # switches to executing another network block.  The per-layer L2
    # weight fetches of the cost model stay as-is; this charges the
    # *off-chip* refill of the weight level on block switches only, so
    # single-block workloads are bit-identical to the seed.
    block_of = workload.block_of
    block_core_weights: dict[tuple[int, int], int] = {}
    if block_of:
        for st in schedule.stages:
            for lname in st.layers:
                ww = workload.layers[lname].weight_words()
                if ww:
                    key = (st.core, block_of.get(lname, 0))
                    block_core_weights[key] = \
                        block_core_weights.get(key, 0) + ww
    resident_block: dict[int, int] = {}
    reload_words = 0
    reload_cycles = 0.0

    total_energy = 0.0
    total_feat_words = 0
    total_macs = 0
    total_vops = 0
    makespan = 0.0

    while total_remaining:
        best = None
        for ci, c in enumerate(core_list):
            queue = core_stages[c]
            while cur[c] < len(queue) and queue[cur[c]].remaining == 0:
                cur[c] += 1
            if cur[c] >= len(queue):
                continue
            ss = queue[cur[c]]
            st = ss.stage
            for lname in ss.active:
                i = ss.idx[lname]
                nds = split[lname]
                if i >= len(nds):
                    continue
                node = nds[i]
                # bounded skew on streamed edges (double buffering)
                blocked = False
                for a, b in st.streamed:
                    if lname == a and b in ss.idx and split.get(b) and \
                            ss.idx[a] > ss.idx[b] + 1:
                        blocked = True
                        break
                if blocked:
                    continue
                dep_t = dep_ready_time(lname, node.row_start,
                                       node.row_end, c)
                if dep_t is None:
                    continue
                rkey = (c, "simd" if node.simd else "array")
                start = max(res_free.get(rkey, 0.0), dep_t)
                key = (start, ci, st.layers.index(lname), i)
                if best is None or key < best[0]:
                    best = (key, c, ss, lname, node, rkey)
        if best is None:
            stuck = [tuple(ss.stage.layers)
                     for c in core_list for ss in core_stages[c]
                     if ss.remaining]
            raise IllegalSchedule(
                f"deadlock in {schedule.name}: no runnable node in "
                f"stages {stuck} (check Step-2 rules / cross-core "
                "dependency cycles)")
        _, c, ss, lname, node, rkey = best
        # commit: re-resolve dependencies, booking transfers for real
        dep_t = dep_ready_time(lname, node.row_start, node.row_end, c,
                               commit=True)
        start = max(res_free.get(rkey, 0.0), dep_t)
        # weight residency: switching blocks refills this core's weight
        # memory from off-chip (the first block a core touches is part
        # of the ambient per-layer weight fetches, not a reload)
        if block_of:
            blk = block_of.get(lname, 0)
            prev_blk = resident_block.get(c)
            resident_block[c] = blk
            if prev_blk is not None and prev_blk != blk:
                rw = block_core_weights.get((c, blk), 0)
                if rw:
                    rc = rw / max(accel.offchip_bandwidth, 1e-9)
                    start += rc
                    reload_words += rw
                    reload_cycles += rc
                    total_energy += rw \
                        * accel.core(c).levels[-1].read_energy
        layer = workload.layers[lname]
        s_in = any((p, lname) in streamed_pairs
                   for p in (layer.feature_inputs() or ()))
        s_out = lname in streamed_producers
        core = accel.core(c)
        lat = cm.node_latency(node, layer, core, s_in, s_out)
        end = start + lat
        res_free[rkey] = end
        makespan = max(makespan, end)
        comp[lname].append(end)
        e, fw = cm.node_energy(node, layer, core, s_in, s_out)
        total_energy += e
        total_feat_words += fw
        total_macs += node.macs
        total_vops += node.vector_ops
        apply_completion(node, c, end)
        ss.idx[lname] += 1
        ss.remaining -= 1
        total_remaining -= 1

    # fold events into a trace + peaks (atomic per (time, rank, core))
    events.sort(key=lambda e: (e[0], e[1]))
    per_core = {}
    per_core_peak = {}
    trace = []
    total = 0
    i = 0
    while i < len(events):
        t, rank = events[i][0], events[i][1]
        j = i
        while j < len(events) and events[j][0] == t and events[j][1] == rank:
            _, _, ec, d = events[j]
            per_core[ec] = per_core.get(ec, 0) + d
            total += d
            j += 1
        for ec in per_core:
            per_core_peak[ec] = max(per_core_peak.get(ec, 0), per_core[ec])
        trace.append((t, total))
        i = j
    peak = max((w for _, w in trace), default=0)

    # optional size-scaled SRAM energy: a memory sized for THIS
    # schedule's peak is cheaper per access (paper Sec. IV.C.3)
    total_energy += links.comm_energy_pj
    l1 = accel.core(0).levels[0]
    scale = l1.scaled_access_energy(peak) / l1.read_energy
    energy_scaled = total_energy \
        + total_feat_words * l1.read_energy * (scale - 1.0)

    return sch.Result(
        schedule=schedule.name,
        latency_cycles=makespan,
        energy_pj=total_energy,
        energy_scaled_pj=energy_scaled,
        peak_active_words=peak,
        per_core_peak=per_core_peak,
        trace=trace,
        macs=total_macs,
        vector_ops=total_vops,
        comm_cycles=links.comm_cycles,
        comm_energy_pj=links.comm_energy_pj,
        link_utilization=links.utilization(makespan),
        kv_cache_words=workload.kv_cache_words,
        weight_reload_words=reload_words,
        weight_reload_cycles=reload_cycles,
    )
