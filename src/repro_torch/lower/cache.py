"""The LRU plan cache: ``(config, phase, seq/ctx bucket)`` ->
:class:`~repro_torch.lower.plan.ExecutionPlan` (a port of
``repro/lower/cache.py``).

Lowering is host work (build the workload network, run the decision
rule, validate the assembled schedule), far too slow to repeat per
kernel call, so plans are cached per bucket of the length.  Prefill
buckets the prompt rows M to the next power of two; decode buckets the
context C with the first edge pinned at the analytical crossover
C = 2N, doubling from there.  A plan is lowered for its bucket's upper
edge, so the kernel path switches where a context crosses an edge.
ModelConfig is a frozen dataclass, hence the key; shape-only keys
(``kernels/ops.py``'s plan-less ``impl="auto"``) use
:class:`HeadConfig`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Optional

from repro_torch.lower import lowering
from repro_torch.lower.plan import ExecutionPlan

__all__ = ["bucket_for", "resolve_plan", "plan_cache_info",
           "clear_plan_cache", "HeadConfig", "head_config", "kernel_plan",
           "LOWERINGS", "lowering_totals"]

#: the latest cold lowerings (cache misses), oldest first: (config name,
#: phase, bucket, decode_tokens, n_blocks, host seconds)
LOWERINGS: collections.deque = collections.deque(maxlen=256)
_TOTALS = [0, 0.0]     # every cold lowering: count, host seconds


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
    t0 = time.perf_counter()
    if phase == "decode":
        plan = lowering.lower(cfg, "decode", bucket,
                              decode_tokens=decode_tokens,
                              n_blocks=n_blocks, bucket=bucket)
    else:
        plan = lowering.lower(cfg, "prefill", bucket, n_blocks=n_blocks,
                              bucket=bucket)
    secs = time.perf_counter() - t0
    LOWERINGS.append((getattr(cfg, "name", ""), phase, bucket,
                      decode_tokens, n_blocks, secs))
    _TOTALS[0] += 1
    _TOTALS[1] += secs
    return plan


def resolve_plan(cfg, phase: str, seq_len: int, *,
                 decode_tokens: int = 1,
                 n_blocks: int = 1) -> ExecutionPlan:
    """The cached plan governing ``seq_len`` (prompt rows for prefill,
    context depth for decode)."""
    dims_n = getattr(cfg, "head_dim", 0) or cfg.d_model // cfg.n_heads
    bucket = bucket_for(phase, seq_len, dims_n)
    if phase != "decode":
        decode_tokens = 1       # irrelevant to prefill: one entry per bucket
    return _resolve(cfg, phase, bucket, decode_tokens, n_blocks)


def plan_cache_info():
    """``functools.lru_cache`` statistics of the plan cache (hits,
    misses, currsize): a miss is one cold ``lowering.lower``."""
    return _resolve.cache_info()


def lowering_totals() -> tuple:
    """(cold lowerings, their host seconds) since the process began:
    the difference of two readings is the plan resolution a run paid,
    which is host time outside the kernels."""
    return _TOTALS[0], _TOTALS[1]


def clear_plan_cache() -> None:
    _resolve.cache_clear()


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """A minimal hashable ModelConfig stand-in built from a kernel
    call's shapes, for plan resolution where no ModelConfig is in scope
    (``kernels/ops.py`` ``impl="auto"``).  Duck-typed against
    ``workload._config_dims``; d_ff is nominal (the FFN does not move
    the attention kernel path)."""

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    mlp: str = "silu_glu"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads

    @property
    def head_dim(self) -> int:
        return self.d_head


def head_config(d_head: int, n_heads: int = 1,
                n_kv_heads: int = 1) -> HeadConfig:
    """The shape-only config of one attention call: ``n_heads`` query
    heads of width ``d_head`` over ``n_kv_heads`` KV heads (one, MQA,
    where the grouping does not divide)."""
    if n_heads % max(n_kv_heads, 1):
        n_kv_heads = 1              # grouping must divide; degrade to MQA
    return HeadConfig(
        name=f"head{n_heads}x{d_head}", d_model=n_heads * d_head,
        n_heads=n_heads, n_kv_heads=max(n_kv_heads, 1), d_head=d_head,
        d_ff=4 * n_heads * d_head)


def kernel_plan(*, seq_q: int, seq_kv: int, d_head: int,
                n_heads: int = 1, n_kv_heads: int = 1,
                phase: Optional[str] = None) -> ExecutionPlan:
    """The ExecutionPlan governing one attention kernel call, from its
    shapes alone.  Without ``phase``: a handful of query rows against a
    deeper key/value buffer is the decode regime, anything else
    prefill/training self-attention."""
    if phase is None:
        phase = "decode" if (seq_q <= 4 and seq_kv > seq_q) else "prefill"
    cfg = head_config(d_head, n_heads, n_kv_heads)
    n = seq_kv if phase == "decode" else seq_q
    return resolve_plan(cfg, phase, n, decode_tokens=max(seq_q, 1))
