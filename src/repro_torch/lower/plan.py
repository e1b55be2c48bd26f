"""ExecutionPlan: the executable form of one phase's schedule decision
(a port of ``repro/lower/plan.py`` without the engine predictions).

A plan holds the kernel path the decision rule picked for one
``(config, phase, bucket)`` and a ledger of every runtime deviation
from it (``record_downgrade``) and of what the runtime did on the
planned path (``note``), so a measured run is labelled with the path it
actually took.
"""

from __future__ import annotations

import dataclasses

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


def kernel_path_for(fuse_q: bool, fuse_scores: bool,
                    fuse_block: bool = False) -> str:
    """The decision rule's fusion flags -> a runtime kernel path.
    Q-fusion without score fusion has no kernel of its own and stays
    ``unfused``; ``fuse_block`` escalates to the megakernel."""
    if fuse_block:
        return DECODE_MEGAKERNEL
    if fuse_scores:
        return QPROJ_ATTENTION if fuse_q else FUSED_ATTENTION
    return UNFUSED


@dataclasses.dataclass
class Downgrade:
    """One (deduplicated) runtime deviation from the planned path."""

    reason: str
    from_path: str
    to_path: str
    count: int = 1


@dataclasses.dataclass
class ExecutionPlan:
    """The decision for one (config, phase, bucket).  Every block of a
    model gets the same decision, so one record covers the network."""

    config_name: str
    phase: str                      # "prefill" | "decode"
    M: int                          # query rows per block
    score_cols: int                 # score-matrix width C (the bucket edge)
    head_dim: int                   # N
    n_blocks: int
    bucket: int
    alpha: float                    # predicted A_fused / A_LBL
    crossover_ctx: int              # 2N: the decode kernel-path switch
    fuse_q: bool
    fuse_scores: bool
    fuse_block: bool = False
    downgrades: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def kernel_path(self) -> str:
        return kernel_path_for(self.fuse_q, self.fuse_scores,
                               self.fuse_block)

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

    def __repr__(self) -> str:
        down = f", downgrades={len(self.downgrades)}" \
            if self.downgrades else ""
        return (f"<ExecutionPlan {self.config_name} {self.phase} "
                f"M={self.M} C={self.score_cols} N={self.head_dim} "
                f"bucket={self.bucket} path={self.kernel_path} "
                f"x{self.n_blocks} blocks{down}>")
