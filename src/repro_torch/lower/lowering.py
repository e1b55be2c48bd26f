"""Schedule lowering: compile a ``fusion.PhasePlan`` into an
:class:`~repro_torch.lower.plan.ExecutionPlan` (a port of
``repro/lower/lowering.py``).

Given the DSE's whole-network schedule for one phase, emit the
per-block records (kernel path, the path's kernel tiles from
``codesign.plan_tiling``, the stream-vs-materialise sets) that
``kernels/ops.py`` and the serving engine dispatch on.
``lower/cache.py`` memoizes the result per ``(config, phase, bucket)``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import codesign
from repro_torch.core import fusion
from repro_torch.core import workload as wl
from repro_torch.lower.plan import BlockPlan, ExecutionPlan, kernel_path_for

__all__ = ["lower_phase_plan", "lower", "supported"]


def lower_phase_plan(pp: fusion.PhasePlan, *,
                     bucket: Optional[int] = None) -> ExecutionPlan:
    """Lower one :class:`fusion.PhasePlan` into an ExecutionPlan.

    Every block of the network gets its own :class:`BlockPlan`; since
    ``phase_schedule`` applies one decision in every (identical) block,
    the records are homogeneous, which is asserted here: the runtime
    takes one kernel path per phase for every layer."""
    n_blocks = max(len(pp.workload.period_prefixes), 1)
    tiling = codesign.plan_tiling(
        pp.phase, pp.M, pp.score_cols, pp.head_dim,
        path=kernel_path_for(pp.fuse_q, pp.fuse_scores, pp.fuse_block))
    blocks = tuple(
        BlockPlan.build(i, pp.phase, pp.policy, pp.fuse_q,
                        pp.fuse_scores, tiling, fuse_block=pp.fuse_block)
        for i in range(n_blocks))
    assert len({(b.kernel_path, b.tiling) for b in blocks}) == 1, \
        "identical blocks must lower to identical records"
    return ExecutionPlan(
        config_name=pp.workload.name,
        phase=pp.phase, M=pp.M, score_cols=pp.score_cols,
        head_dim=pp.head_dim, n_blocks=n_blocks,
        bucket=bucket if bucket is not None else pp.score_cols,
        alpha=pp.alpha, crossover_ctx=2 * pp.head_dim,
        blocks=blocks, source=pp)


def lower(cfg, phase: str, seq_len: int, *, decode_tokens: int = 1,
          n_blocks: int = 1, bucket: Optional[int] = None,
          fuse_q: Optional[bool] = None,
          fuse_scores: Optional[bool] = None,
          fuse_block: Optional[bool] = None) -> ExecutionPlan:
    """Select (``fusion.phase_schedule``) and lower in one step.

    ``cfg`` is a ModelConfig-like object (``workload.from_model_config``;
    GQA/MHA only).  ``phase`` "prefill" takes ``seq_len`` as the prompt
    rows M; "decode" takes it as the context depth C, with
    ``decode_tokens`` = M.  ``bucket`` is recorded on the plan (default
    the score width).  ``fuse_q``/``fuse_scores``/``fuse_block``
    override the decision rule, to lower counterfactual schedules (the
    layer-by-layer baseline, or the qproj path where the rule would
    take the megakernel); ``fuse_block`` without both flags raises
    ``ValueError``."""
    pp = fusion.phase_schedule(cfg, phase, seq_len,
                               decode_tokens=decode_tokens,
                               n_blocks=n_blocks, fuse_q=fuse_q,
                               fuse_scores=fuse_scores,
                               fuse_block=fuse_block)
    plan = lower_phase_plan(pp, bucket=bucket)
    # keep the registry name (workload names embed M/C)
    name = getattr(cfg, "name", None)
    if name:
        plan.config_name = name
    return plan


def supported(cfg) -> bool:
    """True when ``cfg`` is expressible as a DSE workload (GQA/MHA
    attention blocks).  MLA, SSM and hybrid configs are not: the
    serving layer then keeps its config-driven dispatch."""
    try:
        wl._config_dims(cfg)
        return True
    except (ValueError, AttributeError):
        return False
