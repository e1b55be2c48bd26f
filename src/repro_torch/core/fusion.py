"""The paper's shape-driven decision rule as the serving plan uses it;
a copy of ``repro/core/fusion.py`` ``select_schedule`` (:327-342),
``phase_policy`` (:398-416) and the decode-megakernel rule (:552-558).
The DSE engine that assembles and evaluates whole schedules is not
ported yet."""

from __future__ import annotations

from repro_torch.core import analytical


def select_schedule(M: int, N: int) -> str:
    """Fuse through the largest intermediate (Sec. IV.C.3): 'fuse_pv'
    for M > N, 'fuse_q_qkt' for M < N, 'lbl' at M == N (no gain)."""
    if M > N:
        return "fuse_pv"
    if M < N:
        return "fuse_q_qkt"
    return "lbl"


def phase_policy(phase: str, M: int, score_cols: int,
                 head_dim: int) -> tuple[bool, bool]:
    """(fuse_q, fuse_scores): prefill follows :func:`select_schedule`;
    decode always streams Q into QK^T and streams the score pipeline
    exactly when ``alpha_kv < 1``, i.e. C > 2N."""
    if phase == "prefill":
        sel = select_schedule(M, head_dim)
        return sel == "fuse_q_qkt", sel == "fuse_pv"
    if phase == "decode":
        return True, analytical.alpha_kv(M, score_cols, head_dim) < 1.0
    raise ValueError(f"unknown phase {phase!r}")


def fuse_block(phase: str, M: int, fuse_q: bool, fuse_scores: bool) -> bool:
    """The decode megakernel is the M=1 endpoint of the fusion ladder:
    a single-token decode step past the crossover (both flags on)."""
    return phase == "decode" and M == 1 and fuse_q and fuse_scores
