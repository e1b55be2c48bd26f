"""Plan-driven dispatch (a port of ``repro/lower/runtime.py``): turn an
ExecutionPlan into what one attention call needs, and re-resolve plans
as the serving context grows.

* :func:`dispatch` legalises one plan for one call site: it maps the
  kernel path to an ``ops`` impl for the plan's device, walks down the
  ladder where the call site cannot take the planned path (qk-norm
  between projection and scores; no Wo/residual at the call site), and
  records every such step on the plan.
* :func:`rung_down` walks a legalised dispatch one rung down the
  ladder, the serving engine's ``demotions`` recovery.
* :class:`ServingPlan` is the serving engine's handle: the prefill plan
  per prompt bucket, the decode plan per context bucket, and a log of
  every resolution.  The first decode bucket edge sits at the
  crossover C = 2N, so a generation that crosses it switches kernel
  path that step.  A paged plan (``paged=True``) legalises every
  dispatch for a KV page pool read through block tables.

A dispatch carries the plan's tiles (``codesign.plan_tiling``: the
tiles the CUDA kernel for its path launches) for the record only; the
kernels fix their own at compile time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.lower import cache as plan_cache
from repro_torch.lower import lowering
from repro_torch.lower.plan import (DECODE_MEGAKERNEL, FUSED_ATTENTION,
                                    QPROJ_ATTENTION, UNFUSED, ExecutionPlan)
from repro_torch.models.common import resolve_device

__all__ = ["PlanDispatch", "dispatch", "impl_for", "rung_down",
           "shape_dispatch", "ServingPlan", "serving_plan"]


def impl_for(path: str, device) -> str:
    """A kernel path -> an ``kernels.ops`` impl: the unfused path is the
    materialising reference; fused paths run the CUDA kernels on a CUDA
    device and their plain PyTorch versions only where the caller asked
    for the CPU."""
    if path == UNFUSED:
        return "reference"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


@dataclasses.dataclass
class PlanDispatch:
    """What one attention call site needs from the plan: the legalised
    path, its impl, the plan's tiles (a record: the kernels keep their
    own) and the plan for downgrade records."""

    plan: ExecutionPlan
    path: str                   # legalised kernel path
    impl: str                   # cuda | torch | reference
    block_q: int
    block_k: int
    paged: bool = False         # the call site passes a KV page pool and
    #                             block tables instead of dense caches

    @property
    def fuse_q(self) -> bool:
        """Hand the kernel pre-projection activations + Wq, not Q."""
        return self.path in (QPROJ_ATTENTION, DECODE_MEGAKERNEL)

    @property
    def fuse_wo(self) -> bool:
        """Hand over Wo and the residual too: one launch per sub-block."""
        return self.path == DECODE_MEGAKERNEL

    def __repr__(self) -> str:
        return (f"<PlanDispatch {self.path}/{self.impl} "
                f"blocks=({self.block_q},{self.block_k}) of {self.plan!r}>")


def dispatch(plan: ExecutionPlan, *, device,
             entry: str = "attention", rope: bool = False,
             qk_norm: bool = False, lengths_masked: bool = False,
             paged: bool = False) -> PlanDispatch:
    """Legalise ``plan`` for one call site.

    ``device`` is where the call runs, with no default: it decides
    whether a fused path runs its CUDA kernel or its plain version.
    ``entry`` says what the call site can hand the kernel: "attention"
    (a materialised Q), "qproj_attention" (x and Wq) or "decode_block"
    (x, Wq, Wo and the residual).  qk-norm between the projection and
    the scores breaks Q-fusion; RoPE does not (the kernels rotate the Q
    tile themselves).  A ``lengths`` mask keeps fused paths on their
    kernels: a note, never a downgrade.  ``paged``: the call site
    stores KV as a page pool and (B, max_pages) block tables.  On the
    ``cuda`` impl that is a note (the paged kernels read the pool
    through the table); on any other impl the pool is gathered dense
    before the masked path runs, recorded as the JAX package's
    paged->masked-dense downgrade (the dispatch stays ``paged`` so the
    call site still passes its tables; ``kernels.ops`` gathers).
    """
    path = plan.kernel_path
    if path == DECODE_MEGAKERNEL:
        blocked = []
        if entry != "decode_block":
            blocked.append("Wo/residual not available at this call site")
        if qk_norm:
            blocked.append("qk-norm between projection and scores")
        if blocked:
            if entry in ("qproj_attention", "decode_block") \
                    and not qk_norm:
                new = QPROJ_ATTENTION
            elif plan.block(0).fuse_scores:
                new = FUSED_ATTENTION
            else:
                new = UNFUSED
            plan.record_downgrade("; ".join(blocked), path, new)
            path = new
    if path == QPROJ_ATTENTION:
        blocked = []
        if entry not in ("qproj_attention", "decode_block"):
            blocked.append("Q already materialised at this call site")
        if qk_norm:
            blocked.append("qk-norm between projection and scores")
        if blocked:
            new = FUSED_ATTENTION if plan.block(0).fuse_scores else UNFUSED
            plan.record_downgrade("; ".join(blocked), path, new)
            path = new
    if rope and path in (QPROJ_ATTENTION, DECODE_MEGAKERNEL):
        plan.note("RoPE fused in-kernel: Q tile rotated between "
                  "projection and scores")
    impl = impl_for(path, device)
    if lengths_masked and impl == "cuda":
        plan.note("masked-lengths calls take the masked CUDA kernels "
                  "(KV tiles past each row's valid prefix skipped)")
    if paged:
        if impl == "cuda":
            plan.note("paged KV: block-table-indirect CUDA kernels (each "
                      "KV tile's slice of the table staged in shared "
                      "memory; pages past a row's length never read)")
        else:
            plan.record_downgrade(
                f"paged KV block tables unsupported on impl '{impl}': "
                "pool gathered to masked-dense", path, path)
    t = plan.tiling
    return PlanDispatch(plan=plan, path=path, impl=impl, block_q=t.block_q,
                        block_k=t.block_kv, paged=paged)


def shape_dispatch(*, seq_q: int, seq_kv: int, d_head: int, n_heads: int,
                   n_kv_heads: int, device, entry: str = "attention",
                   lengths_masked: bool = False) -> Optional[PlanDispatch]:
    """The shape-only plan of one call (``lower.cache.kernel_plan``:
    ``seq_q`` rows against ``seq_kv`` columns, ``n_heads`` heads of
    ``d_head`` over ``n_kv_heads``) legalised for ``entry`` on
    ``device``; None where that head config is no DSE workload."""
    if not lowering.supported(plan_cache.head_config(d_head, n_heads,
                                                     n_kv_heads)):
        return None
    plan = plan_cache.kernel_plan(seq_q=seq_q, seq_kv=seq_kv, d_head=d_head,
                                  n_heads=n_heads, n_kv_heads=n_kv_heads)
    return dispatch(plan, device=device, entry=entry,
                    lengths_masked=lengths_masked)


#: the lowering ladder, top rung first; rung-down recovery walks it
#: path by path and ends at the chunked plain unfused bottom rung
_LADDER = [DECODE_MEGAKERNEL, QPROJ_ATTENTION, FUSED_ATTENTION, UNFUSED]


def rung_down(d: PlanDispatch,
              reason: str = "kernel launch failure"
              ) -> Optional[PlanDispatch]:
    """One step down the lowering ladder from a legalised dispatch:
    ``decode_megakernel -> qproj_attention -> fused_attention ->
    unfused/reference -> unfused/torch``, recorded on the plan's
    downgrade ledger.  Returns the demoted dispatch, or None from the
    bottom rung.

    The JAX ladder's last step is ``unfused/reference -> unfused/xla``,
    its chunked streaming fallback.  The port has no ``xla`` impl; its
    counterpart is the ``torch`` impl, whose entry points run the
    chunked online-softmax plain versions (``kernels/chunked.py``, the
    port of that fallback), so the port's last step is
    ``unfused/reference -> unfused/torch``, and the ladder has the JAX
    ladder's length.  Fused rungs keep their impl (``cuda`` on the card,
    ``torch`` on the CPU)."""
    if d.path != UNFUSED:
        new_path = _LADDER[_LADDER.index(d.path) + 1]
        new_impl = "reference" if new_path == UNFUSED else d.impl
    elif d.impl != "torch":
        new_path, new_impl = d.path, "torch"
    else:
        return None
    d.plan.record_downgrade(
        f"{reason}: rung-down {d.path}/{d.impl} -> "
        f"{new_path}/{new_impl}", d.path, new_path)
    return dataclasses.replace(d, path=new_path, impl=new_impl)


@dataclasses.dataclass
class ServingPlan:
    """The serving engine's plan handle for one model on ``device``
    (required: fused paths run the CUDA kernels on a CUDA device and
    the plain versions only on the CPU).  ``resolutions`` logs every
    (phase, length, bucket, path, impl) the engine acted on.  ``paged``/
    ``page_size``: the engine stores KV as a page pool and block tables,
    and every dispatch is legalised on that axis."""

    cfg: object
    max_len: int
    device: torch.device
    n_blocks: int = 1
    paged: bool = False
    page_size: Optional[int] = None
    resolutions: list = dataclasses.field(default_factory=list)
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def _dispatch(self, phase: str, n: int,
                  decode_tokens: int = 1) -> PlanDispatch:
        plan = plan_cache.resolve_plan(self.cfg, phase, n,
                                       decode_tokens=decode_tokens,
                                       n_blocks=self.n_blocks)
        # the model hands the kernel x + Wq on every cached call, and
        # Wo + the residual on M=1 steps
        entry = "attention"
        if phase == "decode":
            entry = "decode_block" if decode_tokens == 1 \
                else "qproj_attention"
        d = dispatch(plan, device=self.device, entry=entry,
                     rope=self.cfg.rope_theta > 0,
                     qk_norm=self.cfg.qk_norm, lengths_masked=True,
                     paged=self.paged)
        self.resolutions.append((phase, n, plan.bucket, d.path, d.impl))
        self._plans[id(plan)] = plan
        return d

    def plans(self) -> list:
        """The ExecutionPlans this handle resolved, in first-use order."""
        return list(self._plans.values())

    def downgrades(self) -> list:
        """Every downgrade recorded on the ExecutionPlans this handle
        resolved.  Plans are cached and shared by every handle of the
        same config: clear the plan cache first to read one run's."""
        return [g for plan in self._plans.values() for g in plan.downgrades]

    def prefill_dispatch(self, seq_len: int) -> PlanDispatch:
        return self._dispatch("prefill", seq_len)

    def decode_dispatch(self, ctx_len: int) -> PlanDispatch:
        """The plan of one decode step whose scores span ``ctx_len``
        columns (cache prefix + the new token)."""
        return self._dispatch("decode", min(max(ctx_len, 1), self.max_len))

    def chunk_dispatch(self, ctx_len: int, rows: int) -> PlanDispatch:
        """The plan of one prefill chunk: ``rows`` new rows whose scores
        span ``ctx_len`` columns.  The first chunk (no prefix) is plain
        prefill; later chunks resolve like decode with
        ``decode_tokens = rows``."""
        ctx_len = min(max(ctx_len, 1), self.max_len)
        if ctx_len <= rows:
            return self._dispatch("prefill", rows)
        return self._dispatch("decode", ctx_len, decode_tokens=rows)

    def step_dispatch(self, live_lens) -> PlanDispatch:
        """One whole-batch decode dispatch: the deepest live row picks
        the bucket; the per-row lengths do the per-row work skipping."""
        deepest = max((int(v) for v in live_lens), default=0)
        return self.decode_dispatch(deepest + 1)

    def concrete_ctx(self, cache_len) -> int:
        """Host-side context length of a DecodeState's ``cache_len`` (an
        int or a (B,) tensor): the deepest row governs the step."""
        if isinstance(cache_len, torch.Tensor):
            return int(cache_len.max()) if cache_len.ndim else \
                int(cache_len)
        return int(cache_len)


def serving_plan(cfg, max_len: int, *, device="cuda", n_blocks=None,
                 paged: bool = False,
                 page_size: Optional[int] = None) -> Optional[ServingPlan]:
    """The ServingPlan for ``cfg`` on ``device``, which defaults to the
    card and raises without one; None when ``cfg`` is not lowerable
    (``lowering.supported``: only GQA attention blocks are DSE
    workloads, not MLA, SSM or hybrid ones): the engine then keeps its
    config-driven dispatch.  ``paged``/``page_size``: plan for a paged
    KV pool; ``max_len`` must then be a multiple of the page size."""
    dev = resolve_device(device)
    if not lowering.supported(cfg):
        return None
    if paged and page_size is not None and max_len % page_size:
        raise ValueError(
            f"max_len {max_len} not a multiple of page_size {page_size}")
    return ServingPlan(cfg=cfg, max_len=max_len, device=dev,
                       n_blocks=n_blocks or cfg.n_layers, paged=paged,
                       page_size=page_size)
