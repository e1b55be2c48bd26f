"""The LRU plan cache: ``(config, phase, seq/ctx bucket)`` ->
:class:`~repro_torch.lower.plan.ExecutionPlan` (a port of
``repro/lower/cache.py:42-81``).

Prefill buckets the prompt rows M to the next power of two; decode
buckets the context C with the first edge pinned at the analytical
crossover C = 2N, doubling from there.  A plan is decided for its
bucket's upper edge, so the kernel path switches where a context
crosses an edge.  ModelConfig is a frozen dataclass, hence the key.
"""

from __future__ import annotations

import functools

from repro_torch.core import analytical, fusion
from repro_torch.lower.plan import ExecutionPlan

__all__ = ["bucket_for", "resolve_plan", "clear_plan_cache"]


def bucket_for(phase: str, n: int, head_dim: int) -> int:
    """The bucket (its inclusive upper edge) holding length ``n``.

    >>> bucket_for("decode", 40, 32)
    64
    >>> bucket_for("decode", 65, 32)
    128
    >>> bucket_for("prefill", 200, 32)
    256
    """
    n = max(int(n), 1)
    edge = 2 * head_dim if phase == "decode" else 1
    while edge < n:
        edge *= 2
    return edge


@functools.lru_cache(maxsize=256)
def _resolve(cfg, phase: str, bucket: int, decode_tokens: int,
             n_blocks: int) -> ExecutionPlan:
    n = cfg.head_dim
    if phase == "decode":
        M, cols = decode_tokens, bucket
        alpha = analytical.alpha_kv(M, cols, n)
    elif phase == "prefill":
        M = cols = bucket
        alpha = analytical.alpha(M, n)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    fuse_q, fuse_scores = fusion.phase_policy(phase, M, cols, n)
    return ExecutionPlan(
        config_name=cfg.name, phase=phase, M=M, score_cols=cols,
        head_dim=n, n_blocks=n_blocks, bucket=bucket, alpha=alpha,
        crossover_ctx=2 * n, fuse_q=fuse_q, fuse_scores=fuse_scores,
        fuse_block=fusion.fuse_block(phase, M, fuse_q, fuse_scores))


def resolve_plan(cfg, phase: str, seq_len: int, *,
                 decode_tokens: int = 1,
                 n_blocks: int = 1) -> ExecutionPlan:
    """The cached plan governing ``seq_len`` (prompt rows for prefill,
    context depth for decode)."""
    bucket = bucket_for(phase, seq_len, cfg.head_dim)
    if phase != "decode":
        decode_tokens = 1       # irrelevant to prefill: one entry per bucket
    return _resolve(cfg, phase, bucket, decode_tokens, n_blocks)


def clear_plan_cache() -> None:
    _resolve.cache_clear()
