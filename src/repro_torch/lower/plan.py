"""ExecutionPlan: the executable form of one phase's DSE schedule (a
port of ``repro/lower/plan.py``).

The DSE core (``repro_torch/core``) picks a phase-aware fused schedule
as a ``fusion.PhasePlan``: a workload DAG and a list of stages.  The
runtime speaks of kernel entry points instead: which of the port's
CUDA kernels a call takes, with which tiles, and which intermediates
stream through on-chip memory rather than materialise.  A plan holds
one :class:`BlockPlan` per block of the network, the source PhasePlan
for the engine's predictions (:meth:`ExecutionPlan.predict`), and a
ledger of every runtime deviation from the planned path
(``record_downgrade``) and of what the runtime did on it (``note``), so
a measured run is labelled with the path it actually took.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import codesign
from repro_torch.core import scheduler as sch

__all__ = [
    "UNFUSED", "FUSED_ATTENTION", "QPROJ_ATTENTION",
    "DECODE_MEGAKERNEL", "KERNEL_PATHS",
    "BlockPlan", "Downgrade", "ExecutionPlan",
]

#: scores and Q materialised: the layer-by-layer reference path.
#: Chosen when fusion has no predicted gain (prefill M <= N, decode
#: C <= 2N).
UNFUSED = "unfused"
#: Fig. 5c: QK^T -> softmax -> .V streamed (fused_attention_masked)
FUSED_ATTENTION = "fused_attention"
#: Fig. 5b taken all the way: Q = x @ Wq folded into the score kernel
#: (fused_qproj_attention_masked)
QPROJ_ATTENTION = "qproj_attention"
#: the M=1 decode endpoint: projection, scores, softmax, P.V, output
#: projection and residual in one launch (fused_decode_block)
DECODE_MEGAKERNEL = "decode_megakernel"

KERNEL_PATHS = (UNFUSED, FUSED_ATTENTION, QPROJ_ATTENTION,
                DECODE_MEGAKERNEL)

#: per-head layer names of the stream/materialise record (the
#: ``workload.attention_head`` vocabulary, without prefixes)
_HEAD_CHAIN = ("Q", "QKT", "SM", "AV")


def kernel_path_for(fuse_q: bool, fuse_scores: bool,
                    fuse_block: bool = False) -> str:
    """The DSE's per-head fusion flags -> a runtime kernel path.
    Q-fusion without score fusion has no kernel of its own and stays
    ``unfused`` (the flag stays on the BlockPlan, so the gap shows);
    ``fuse_block`` escalates to the megakernel."""
    if fuse_block:
        return DECODE_MEGAKERNEL
    if fuse_scores:
        return QPROJ_ATTENTION if fuse_q else FUSED_ATTENTION
    return UNFUSED


def _streaming(fuse_q: bool, fuse_scores: bool, fuse_block: bool = False
               ) -> tuple[tuple[tuple[str, str], ...], tuple[str, ...]]:
    """(streamed edges, materialised intermediates) per head."""
    streamed: list[tuple[str, str]] = []
    if fuse_q or fuse_block:
        streamed.append(("Q", "QKT"))
    if fuse_scores or fuse_block:
        streamed.extend([("QKT", "SM"), ("SM", "AV")])
    if fuse_block:
        # the megakernel also streams the head output through the
        # output projection and the residual add ("OUT" = resid + y@Wo)
        streamed.extend([("AV", "PROJ"), ("PROJ", "OUT")])
    producers = {a for a, _ in streamed}
    materialized = tuple(n for n in _HEAD_CHAIN[:-1] if n not in producers)
    return tuple(streamed), materialized


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """The executable record of one transformer block in one phase.

    ``kernel_path`` is the DSE's ideal path; legalisation for a call
    site (qk-norm, entry, paged KV, device) happens at dispatch time
    (``lower.runtime.dispatch``) and is logged on the owning
    :class:`ExecutionPlan`, never silently."""

    block_index: int
    phase: str                          # "prefill" | "decode"
    policy: str                         # lbl|fuse_q_qkt|fuse_pv|
    #                                     fuse_all|megakernel
    kernel_path: str                    # one of KERNEL_PATHS
    fuse_q: bool
    fuse_scores: bool
    tiling: codesign.AttentionTiling    # the path's kernel tiles
    streamed: tuple[tuple[str, str], ...]
    materialized: tuple[str, ...]       # intermediates that hit memory
    fuse_block: bool = False            # decode megakernel

    @classmethod
    def build(cls, block_index: int, phase: str, policy: str,
              fuse_q: bool, fuse_scores: bool,
              tiling: codesign.AttentionTiling,
              fuse_block: bool = False) -> "BlockPlan":
        streamed, materialized = _streaming(fuse_q, fuse_scores,
                                            fuse_block)
        return cls(block_index=block_index, phase=phase, policy=policy,
                   kernel_path=kernel_path_for(fuse_q, fuse_scores,
                                               fuse_block),
                   fuse_q=fuse_q, fuse_scores=fuse_scores, tiling=tiling,
                   streamed=streamed, materialized=materialized,
                   fuse_block=fuse_block)


@dataclasses.dataclass
class Downgrade:
    """One (deduplicated) runtime deviation from the planned path."""

    reason: str
    from_path: str
    to_path: str
    count: int = 1


@dataclasses.dataclass
class ExecutionPlan:
    """The lowered schedule of one (config, phase, bucket), from
    ``lower.lowering.lower_phase_plan``.  Every block of a model gets
    the same decision (asserted at lowering), so ``kernel_path`` and
    ``tiling`` read block 0."""

    config_name: str
    phase: str                      # "prefill" | "decode"
    M: int                          # query rows per block
    score_cols: int                 # score-matrix width C (the bucket edge)
    head_dim: int                   # N
    n_blocks: int
    bucket: int
    alpha: float                    # predicted A_fused / A_LBL
    crossover_ctx: int              # 2N: the decode kernel-path switch
    blocks: tuple[BlockPlan, ...]
    source: object                  # the fusion.PhasePlan lowered from
    downgrades: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)
    _predicted: Optional[sch.Result] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- structure ----------------------------------------------------

    def block(self, i: int = 0) -> BlockPlan:
        return self.blocks[i]

    @property
    def kernel_path(self) -> str:
        return self.blocks[0].kernel_path

    @property
    def tiling(self) -> codesign.AttentionTiling:
        return self.blocks[0].tiling

    # -- ledger -------------------------------------------------------

    def record_downgrade(self, reason: str, from_path: str,
                         to_path: str) -> None:
        """Record (deduplicated) that the runtime ran ``to_path`` where
        the plan said ``from_path``."""
        for d in self.downgrades:
            if (d.reason, d.from_path, d.to_path) == \
                    (reason, from_path, to_path):
                d.count += 1
                return
        self.downgrades.append(Downgrade(reason, from_path, to_path))

    def note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)

    @property
    def executed_path(self) -> str:
        """The path the runtime last took: the plan's unless a downgrade
        was recorded."""
        if self.downgrades:
            return self.downgrades[-1].to_path
        return self.kernel_path

    # -- predictions --------------------------------------------------

    def predict(self, accel=None, row_block: Optional[int] = None
                ) -> sch.Result:
        """Engine-evaluate the source schedule: the predicted cycles and
        peak active words that ``validate_costmodel_torch.py`` holds
        measured runs against.  Only the default-platform call is
        memoized; an explicit ``accel``/``row_block`` evaluates afresh."""
        if accel is not None or row_block is not None:
            return self.source.evaluate(accel, row_block=row_block)
        if self._predicted is None:
            self._predicted = self.source.evaluate()
        return self._predicted

    @property
    def predicted_cycles(self) -> float:
        return self.predict().latency_cycles

    @property
    def predicted_peak_words(self) -> int:
        return self.predict().peak_active_words

    def predicted_kv_pages(self, row_lens, page_size: int) -> int:
        """Predicted KV pages for rows at contexts ``row_lens`` under a
        paged cache of ``page_size``-token pages: each live row owns
        ``ceil(len / page_size)`` pages and nothing else."""
        return sum(-(-int(l) // page_size)
                   for l in row_lens if int(l) > 0)

    def predicted_kv_page_words(self, row_lens, page_size: int,
                                n_kv_heads: int, head_dim: int,
                                n_layers: int = 1) -> int:
        """The page prediction in words: K and V planes of every
        allocated page across ``n_layers`` layers."""
        pages = self.predicted_kv_pages(row_lens, page_size)
        return pages * page_size * 2 * n_kv_heads * head_dim * n_layers

    def block_skip_fraction(self, row_lens) -> float:
        """Predicted fraction of per-row KV tiles the masked kernels
        skip in one decode step over rows at contexts ``row_lens``,
        against every row paying the deepest row's depth: each row
        reads ``ceil(len / block_kv)`` tiles of the kernel's
        ``block_kv`` keys."""
        bk = self.tiling.block_kv
        lens = [int(l) for l in row_lens if int(l) > 0]
        if not lens:
            return 0.0
        per_row = [-(-l // bk) for l in lens]
        deepest = max(per_row)
        return 1.0 - sum(per_row) / (deepest * len(per_row))

    # -- rendering ----------------------------------------------------

    def __repr__(self) -> str:
        down = f", downgrades={len(self.downgrades)}" \
            if self.downgrades else ""
        return (f"<ExecutionPlan {self.config_name} {self.phase} "
                f"M={self.M} C={self.score_cols} N={self.head_dim} "
                f"bucket={self.bucket} path={self.kernel_path} "
                f"x{self.n_blocks} blocks{down}>")

    def describe(self) -> str:
        """The plan, one line per block, downgrades and notes after."""
        head = (f"ExecutionPlan[{self.config_name} {self.phase} "
                f"M={self.M} C={self.score_cols} N={self.head_dim} "
                f"bucket={self.bucket} alpha={self.alpha:.3f} "
                f"crossover_ctx={self.crossover_ctx}]")
        lines = [head]
        for b in self.blocks:
            streamed = ",".join(f"{a}->{c}" for a, c in b.streamed) or "-"
            lines.append(
                f"  block {b.block_index}: policy={b.policy} "
                f"path={b.kernel_path} tiling=({b.tiling.block_q},"
                f"{b.tiling.block_kv}) streamed={streamed} "
                f"materialized={','.join(b.materialized) or '-'}")
        for d in self.downgrades:
            lines.append(f"  downgrade: {d.from_path} -> {d.to_path} "
                         f"x{d.count} ({d.reason})")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)
