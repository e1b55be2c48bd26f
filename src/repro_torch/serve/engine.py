"""Continuous-batching serving, dense and paged (a port of
``repro/serve/engine.py``).

Decode is the paper's M < N regime; with a KV cache the crossover moves
to C = 2N.  A :class:`~repro_torch.lower.runtime.ServingPlan` resolves
the kernel path of every prefill chunk and decode step from its context
bucket, so the path switches the step the context crosses an edge:
past 2N, M=1 decode on a RoPE-only config runs the decode megakernel,
chunked prefill the Q-projection kernel, and qk-norm configs stop at
fused attention.

``DecodeState.cache_len`` is a (B,) int32 tensor of per-row write
positions, so one whole-batch decode step serves rows at different
depths.  The lifecycle is ``init_decode_state -> prefill_request ->
insert(result, slot) -> generate``; :class:`ContinuousBatchingEngine`
packages it with host mirrors of per-slot state so step dispatch never
reads device memory.

The paged engine (:class:`PagedContinuousBatchingEngine`) keeps KV in a
page pool shared by all rows, leased through a :class:`PageAllocator`:
prefill stays dense on a B=1 side cache and is paged once, at insert;
decode steps read the pool through ``(B, max_pages)`` block tables;
``preempt`` snapshots a row's pages to host memory and frees them, and
``resume`` scatters the snapshot into fresh pages.

Unlike the JAX engine, state is updated in place: the KV caches are
written by the model's appends, and ``insert``/``evict`` (and their
paged twins) write the slot's rows, length, token and table row into
the batch state's tensors.  A preempted snapshot is therefore a host
copy of gathered pages, never a view into the pool, whose pages are
overwritten once reissued.

An MLA config (deepseek-v3) has no serving plan either: the engine
resolves each prefill chunk and decode step of its latent cache on the
shape-only plan of the absorbed call at the context the host mirrors
know (``_latent_dispatch``), so its decode path changes at C = 2N as a
planned GQA config's does; its latent leaf rides insert, preempt,
resume and snapshots like a K/V leaf, and the paged engine refuses it,
as in the JAX package.

A Mamba-2 config has no serving plan (``serving_plan`` returns None, as
in the JAX package): its layers hold a conv tail and an SSM state per
row, which insert, preempt and resume carry like KV rows; free rows
decode too, and their state is overwritten at the next insert.  The
paged engine refuses such a config.

The attention/Mamba-2 hybrid (jamba) has no serving plan either, and
its cache mixes both: K/V at the attention layers, the conv tail and
fp32 SSM state at the Mamba layers, each carried as above through
insert, preempt, resume and snapshots.  The engine passes its attention
layers no dispatch (there is no override like MLA's
``_latent_dispatch``): each call resolves ``impl="auto"`` inside
``kernels.ops`` on the shape-only plan keyed on the K buffer's length,
the cache's ``max_len``, as the JAX package's ``_auto_dispatch`` keys
on ``k.shape[2]``, so its decode path does not change with the
context.  ``rollback_slot`` and the paged engine refuse the hybrid, as
they refuse any config with Mamba-2 layers.

On a mesh of more than one rank with ``head_parallel_decode`` or
``distributed_decode`` set (``sharding.set_rules_for_mesh``), the engine
serves the sharded serving state (``serve/layout.py``): its weights
are this rank's blocks of JAX's ``param_shardings``, which it checks,
and it allocates only this rank's block of each cache leaf
(``serve.layout.cache_blocks``), the batch over the data axes and over
"model": a K/V leaf's time columns (``distributed_decode``, JAX's
``decode_state_shardings``) or KV heads (``head_parallel_decode``),
MLA's latent by its time columns, a Mamba-2 layer's conv tail by its
channels and SSM state by its heads; ``last_token`` holds the rank's
rows (JAX's ``decode_state_shardings`` splits it over the data axes)
and ``cache_len`` is whole on every rank.  Every rank runs every step:
a B=1 prefill on every rank (its batch does not divide), a decode step
on the rank's rows, whose logits are gathered over the data axes.  A
prefill chunk whose length divides the "model" axis holds its residual
stream as the rank's sequence block between the layers (JAX's
``seq_stream``, ``models/transformer.py``); a decode step's one token,
and a chunk that does not divide, stay whole.
``insert`` writes a slot's row and token on the rank that holds it,
``preempt`` gathers the row's blocks and token from it, and
:meth:`ContinuousBatchingEngine.last_tokens` gathers every rank's
tokens.  The paged engine refuses such a mesh, as the JAX
package refuses paged KV under a mesh path.  A mesh with neither flag
serves the whole state on every rank.

Fault tolerance (``serve/supervisor.py``) rests on three properties of
the engine, as in the JAX package.  A prefill step is retry-safe: the
completions of a step whose later chunk raised wait on
``_insert_backlog`` for the retry to report them.  A decode step is
retry-safe: host mirrors and ``cache_len`` advance only after the step
ran, and the K/V a raised attempt wrote in place lie past each row's
length, where the retry writes them again.  ``rollback_slot`` rewinds a
row's length and token; it refuses a config with Mamba-2 layers, whose
conv tail and SSM state a decode step overwrites in place (the JAX
engine rewinds the length alone there, and its stream then differs
from the fault-free one).  ``fault_injector`` (on the engine and its
``PageAllocator``) is consulted only in chaos runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.lower import rung_down, serving_plan
from repro_torch.lower.runtime import shape_dispatch
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.serve import layout as sl
from repro_torch.sharding.rules import active_mesh


@dataclasses.dataclass
class DecodeState:
    cache: Any
    cache_len: torch.Tensor       # (B,) int32: per-row filled prefix
    #: (B,) int32, or this rank's rows of it (the sharded serving state)
    last_token: torch.Tensor


def make_serving_plan(cfg: ModelConfig, max_len: int, *, device="cuda",
                      paged: bool = False,
                      page_size: Optional[int] = None):
    """The ServingPlan for ``cfg`` on ``device``; ``paged``/``page_size``
    resolve it for paged-KV dispatch."""
    return serving_plan(cfg, max_len, device=device, paged=paged,
                        page_size=page_size)


def _model_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                 device, fsdp=None) -> dict:
    """Zeroed caches: the whole tree, or this rank's blocks of it."""
    if fsdp is None:
        return tf.init_model_cache(cfg, batch, max_len, dtype, device)
    return sl.cache_blocks(fsdp, cfg, batch, max_len, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int,
                      max_len: Optional[int] = None,
                      dtype=torch.bfloat16, *, plan=None,
                      device="cuda", fsdp=None) -> DecodeState:
    """Allocate the cache state; ``max_len`` may come from the plan.
    ``fsdp`` (the sharded serving state's layout): only this rank's
    block of each cache leaf and this rank's rows of ``last_token`` (the
    batch over the data axes, whole where it does not divide);
    ``cache_len`` whole."""
    dev = resolve_device(device)
    if max_len is None:
        if plan is None:
            raise TypeError("init_decode_state: pass max_len or a plan")
        max_len = plan.max_len
    if plan is not None and max_len > plan.max_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds the plan's {plan.max_len}: "
            "contexts past the last plan bucket would be unplanned")
    rows = batch if fsdp is None else sl.batch_block(fsdp, batch)[1]
    return DecodeState(
        cache=_model_cache(cfg, batch, max_len, dtype, dev, fsdp),
        cache_len=torch.zeros(batch, dtype=torch.int32, device=dev),
        last_token=torch.zeros(rows, dtype=torch.int32, device=dev))


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(-1).to(torch.int32)


def prefill(params, cfg: ModelConfig, tokens, state: DecodeState, *,
            embeds=None, plan=None, impl: str = "auto",
            fsdp=None) -> DecodeState:
    """Run the whole prompt at once, filling the caches.  ``embeds``
    (B, S_f, frontend_dim): a stub frontend's rows, placed before the
    ``tokens`` (either may be None); the plan's prefill dispatch and
    the new ``cache_len`` count the rows of both.  ``impl`` and
    ``fsdp``: as :func:`decode_step`'s; under ``fsdp`` the batch must
    not split over the data axes (the engine prefills B=1 states)."""
    rows = sum(t.shape[1] for t in (embeds, tokens) if t is not None)
    dispatch = None if plan is None else plan.prefill_dispatch(rows)
    logits, cache = tf.forward(params, cfg, tokens, embeds,
                               cache=state.cache, cache_len=0,
                               plan=dispatch, impl=impl, fsdp=fsdp)
    return DecodeState(cache=cache,
                       cache_len=torch.full_like(state.cache_len, rows),
                       last_token=greedy_sample(logits))


def chunked_prefill(params, cfg: ModelConfig, tokens, state: DecodeState,
                    *, chunk_size: int, plan=None,
                    fsdp=None) -> DecodeState:
    """Prefill in ``chunk_size``-token chunks, re-resolving the plan per
    chunk: the first chunk is plain prefill, later chunks the KV-cached
    regime.  ``fsdp``: as :func:`prefill`'s."""
    s = tokens.shape[1]
    cache, logits = state.cache, None
    for start in range(0, s, chunk_size):
        piece = tokens[:, start:start + chunk_size]
        dispatch = None if plan is None else plan.chunk_dispatch(
            start + piece.shape[1], piece.shape[1])
        logits, cache = tf.forward(params, cfg, piece, cache=cache,
                                   cache_len=start, plan=dispatch,
                                   fsdp=fsdp)
    return DecodeState(cache=cache,
                       cache_len=torch.full_like(state.cache_len, s),
                       last_token=greedy_sample(logits))


def decode_step(params, cfg: ModelConfig, state: DecodeState, *,
                plan=None, dispatch=None, active=None, block_tables=None,
                impl: str = "auto", fsdp=None):
    """One token for every row.  ``dispatch``: a pre-resolved
    PlanDispatch (``ServingPlan.step_dispatch`` over host-side lengths),
    else resolved from ``plan`` and the state.  ``active``: (B,) bool;
    rows where it is False keep their length and last token.
    ``block_tables``: the (B, max_pages) page table when ``state`` is
    paged; the state's type is kept either way.  ``impl``: the
    ``kernels.ops`` impl of every call (``torch`` forces the plain
    versions).  ``fsdp``: the sharded serving state's layout, whose
    blocks ``params``, ``state.cache`` and ``state.last_token`` are
    (:func:`init_decode_state`): the step runs on this rank's rows (all
    of them unless the batch splits over the data axes), and their
    logits are gathered.  Returns (new state, last-position logits (B,
    vocab))."""
    if dispatch is None and plan is not None:
        dispatch = plan.decode_dispatch(
            plan.concrete_ctx(state.cache_len) + 1)
    batch = state.cache_len.shape[0]
    first, rows = (0, batch) if fsdp is None \
        else sl.batch_block(fsdp, batch)
    logits, cache = tf.forward(
        params, cfg, state.last_token[:, None],
        cache=state.cache, cache_len=state.cache_len[first:first + rows],
        plan=dispatch, block_tables=block_tables, impl=impl, fsdp=fsdp)
    nxt = greedy_sample(logits)              # this rank's rows
    if rows != batch:
        logits = sl.gather_rows(fsdp, logits, batch)
    step = torch.ones_like(state.cache_len)
    if active is not None:
        act = torch.as_tensor(active, device=nxt.device)
        nxt = torch.where(act[first:first + rows], nxt, state.last_token)
        step = act.to(state.cache_len.dtype)
    return dataclasses.replace(state, cache=cache,
                               cache_len=state.cache_len + step,
                               last_token=nxt), logits[:, -1]


# ---------------------------------------------------------------------------
# continuous batching: prefill_request -> insert -> generate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrefillResult:
    """A prefilled request ready to insert: its B=1 cache (at the
    engine's max_len), the prompt length and the first sampled token."""
    cache: Any
    length: int
    next_token: int


def prefill_request(params, cfg: ModelConfig, prompt, *,
                    max_len: Optional[int] = None, plan=None,
                    chunk_size: Optional[int] = None,
                    dtype=torch.float32, device="cuda") -> PrefillResult:
    """Prefill one request on the side (B=1) for ``insert``.  Under the
    sharded serving state (``params`` its blocks) the side cache is
    this rank's blocks too."""
    dev = resolve_device(device)
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                           device=dev).reshape(1, -1)
    layout = sl.serving_layout(cfg, max_len=max_len)
    if layout is not None:
        layout.check_blocks(params)
    state = init_decode_state(cfg, 1, max_len, dtype, plan=plan,
                              device=dev, fsdp=layout)
    if chunk_size is None:
        state = prefill(params, cfg, toks, state, plan=plan, fsdp=layout)
    else:
        state = chunked_prefill(params, cfg, toks, state,
                                chunk_size=chunk_size, plan=plan,
                                fsdp=layout)
    return PrefillResult(cache=state.cache, length=toks.shape[1],
                         next_token=int(state.last_token[0]))


def _rows(cache):
    """(cache leaf, its batch axis) pairs over every leaf of every layer
    (an attention layer's k and v, a mamba layer's conv tail and SSM
    state), as ``jax.tree.map`` walks them: batch is axis 0 of
    prefix-layer caches and axis 1 of the stacked body."""
    for part, axis in (("prefix", 0), ("scan", 1)):
        for layer in cache[part]:
            for block in layer.values():
                for t in block.values():
                    yield t, axis


def _map_leaves(cache, fn):
    """``cache`` with every leaf ``t`` replaced by ``fn(t, axis)``,
    ``axis`` its batch (or page) axis: 0 in the prefix layers, 1 in the
    period-stacked body."""
    def one(layer, axis):
        return {name: {k: fn(t, axis) for k, t in block.items()}
                for name, block in layer.items()}
    return {"prefix": [one(lc, 0) for lc in cache["prefix"]],
            "scan": [one(lc, 1) for lc in cache["scan"]]}


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory that shares no storage with it
    (``.cpu()`` of a CPU tensor would return the tensor itself)."""
    return t.to("cpu", copy=True)


def insert(state: DecodeState, result: PrefillResult, slot: int, *,
           rows: Optional[tuple] = None) -> DecodeState:
    """Write a prefilled request into batch row ``slot`` (cache rows,
    write position, last token), in place; other rows are untouched.
    Every cache leaf is written, a mamba layer's SSM state too, cast to
    the batch leaf's dtype (the state stays fp32).  ``rows``: (first,
    count) of the batch rows this rank's cache blocks and tokens hold
    (the sharded serving state); a rank that does not hold ``slot``
    writes only its position."""
    first, count = rows or (0, state.cache_len.shape[0])
    if first <= slot < first + count:
        for (full, axis), (row, _) in zip(_rows(state.cache),
                                          _rows(result.cache)):
            full.select(axis, slot - first).copy_(row.select(axis, 0))
        state.last_token[slot - first] = result.next_token
    state.cache_len[slot] = result.length
    return state


def evict(state: DecodeState, slot: int, *,
          rows: Optional[tuple] = None) -> DecodeState:
    """Free batch row ``slot``: zero its write position and token (on the
    rank that holds it, ``rows`` as :func:`insert`'s).  The KV rows stay;
    the next insert into the slot overwrites them."""
    first, count = rows or (0, state.cache_len.shape[0])
    state.cache_len[slot] = 0
    if first <= slot < first + count:
        state.last_token[slot - first] = 0
    return state


class ContinuousBatchingEngine:
    """The ``init_decode_state -> prefill -> insert -> generate``
    lifecycle as one object: a fixed-geometry decode batch whose rows
    are leased to requests and reclaimed as they finish, with new
    requests prefilled (chunk by chunk with ``prefill_chunk``) and
    inserted mid-stream.  Host mirrors (``row_ctx``, ``live``) let each
    step's plan be resolved from the live rows' contexts without
    reading device memory.

    ``demotions`` is a standing rung-down count applied to every
    resolved dispatch (``lower.runtime.rung_down``): 0 runs the planned
    path, each unit one rung lower.  ``preempt``/``resume`` snapshot a
    row to host memory and bring it back, the dense twins of the paged
    engine's verbs.  ``impl``: the ``kernels.ops`` impl of every call
    (``auto``: the plan's, else the kernel on the card; ``torch``
    forces the plain versions)."""

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int,
                 max_len: Optional[int] = None, plan=None,
                 dtype=torch.float32, prefill_chunk: Optional[int] = None,
                 device="cuda", impl: str = "auto"):
        if max_len is None:
            if plan is None:
                raise TypeError(
                    "ContinuousBatchingEngine: pass max_len or a plan")
            max_len = plan.max_len
        self.params, self.cfg, self.plan = params, cfg, plan
        self.batch_size, self.max_len = batch_size, max_len
        self.dtype, self.device = dtype, resolve_device(device)
        self.prefill_chunk, self.impl = prefill_chunk, impl
        #: the sharded serving state's layout under the active mesh
        #: (None: the whole state on this rank)
        self.layout = sl.serving_layout(cfg, max_len=max_len)
        if self.layout is not None:
            self.layout.check_blocks(params)
        #: (first, count) of the batch rows this rank's caches hold
        self.rows = (0, batch_size) if self.layout is None \
            else sl.batch_block(self.layout, batch_size)
        self.state = self._init_state()
        self.row_ctx = [0] * batch_size   # host mirror of cache_len
        self.live = [False] * batch_size
        self._pending: dict = {}          # slot -> in-flight prefill
        # completed inserts whose (slot, first_token) the caller has not
        # been handed yet: they survive a launch that raises later in
        # the same _advance_prefills, so its retry reports them
        self._insert_backlog: list = []
        #: standing rung-down count (0: the planned path)
        self.demotions = 0
        #: the serving layer's fault injector (serve/faults.py); None
        #: outside chaos runs
        self.fault_injector = None
        self.last_dispatch = None
        #: the last decode step's last-position logits (B, vocab), on
        #: the device; the last prefill chunk's, per slot
        self.last_logits: Optional[torch.Tensor] = None
        self.prefill_logits: dict = {}

    def _init_state(self):
        return init_decode_state(self.cfg, self.batch_size, self.max_len,
                                 self.dtype, plan=self.plan,
                                 device=self.device, fsdp=self.layout)

    def free_slots(self) -> list:
        return [i for i in range(self.batch_size)
                if not self.live[i] and i not in self._pending]

    def begin_prefill(self, slot: int, prompt) -> None:
        """Lease ``slot`` to a new request: its prompt is prefilled on a
        side B=1 cache, one chunk per ``step()``, and inserted into the
        slot when complete."""
        if self.live[slot] or slot in self._pending:
            raise ValueError(f"slot {slot} is not free")
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=self.device).reshape(1, -1)
        if toks.shape[1] > self.max_len:
            raise ValueError(f"prompt ({toks.shape[1]} tokens) exceeds "
                             f"cache max_len {self.max_len}")
        side = _model_cache(self.cfg, 1, self.max_len, self.dtype,
                            self.device, self.layout)
        self._pending[slot] = {"tokens": toks, "pos": 0, "cache": side}

    def _advance_prefills(self) -> list:
        """One prefill chunk per pending request; insert the ones that
        complete.  Returns [(slot, first_token), ...], with those of an
        earlier call that raised after inserting them."""
        inserted = self._insert_backlog
        for slot, p in list(self._pending.items()):
            total = p["tokens"].shape[1]
            chunk = self.prefill_chunk or total
            piece = p["tokens"][:, p["pos"]:p["pos"] + chunk]
            dispatch = None
            if self.plan is not None:
                dispatch = self._demoted(self.plan.chunk_dispatch(
                    p["pos"] + piece.shape[1], piece.shape[1]))
            elif self.cfg.attention == "mla":
                dispatch = self._demoted(self._latent_dispatch(
                    piece.shape[1], p["pos"] + piece.shape[1]))
            logits, p["cache"] = tf.forward(
                self.params, self.cfg, piece, cache=p["cache"],
                cache_len=p["pos"], plan=dispatch, impl=self.impl,
                fsdp=self.layout)
            p["pos"] += piece.shape[1]
            if p["pos"] >= total:
                self.prefill_logits[slot] = logits[0, -1]
                res = PrefillResult(cache=p["cache"], length=total,
                                    next_token=int(greedy_sample(logits)[0]))
                self._insert(res, slot)
                self.row_ctx[slot] = total
                self.live[slot] = True
                del self._pending[slot]
                inserted.append((slot, res.next_token))
        self._insert_backlog = []
        return inserted

    def _insert(self, res: PrefillResult, slot: int) -> None:
        insert(self.state, res, slot, rows=self.rows)

    def _before_decode(self) -> None:
        """Hook run right before each decode launch (the paged engine
        grows the page lists of rows crossing a page boundary here)."""

    def _latent_dispatch(self, rows: int, ctx: int):
        """MLA has no serving plan (its blocks are no DSE workload, as in
        the JAX package), so its absorbed attention call takes the
        shape-only plan of its heads (Hq query heads of r_kv + rope over
        the one latent head) at ``rows`` new rows and ``ctx`` columns,
        the deepest live row's context, which the host mirrors know.
        Resolved inside ``kernels.ops`` the plan would be keyed on the
        latent buffer's max_len at every step, and the decode path would
        never change with the context."""
        cfg = self.cfg
        return shape_dispatch(
            seq_q=rows, seq_kv=ctx,
            d_head=cfg.kv_lora_rank + cfg.qk_rope_head_dim,
            n_heads=cfg.n_heads, n_kv_heads=1, device=self.device,
            lengths_masked=True)

    def _demoted(self, dispatch):
        """The standing ``demotions`` count applied to a resolved
        dispatch: each unit walks it one rung down the ladder, recorded
        on the plan's downgrade ledger by ``rung_down``."""
        if dispatch is None or not self.demotions:
            return dispatch
        for _ in range(self.demotions):
            lower = rung_down(dispatch, "kernel-failure recovery")
            if lower is None:
                break
            dispatch = lower
        return dispatch

    def _inject_nan(self) -> None:
        """Fault hook: poison one live slot's logits and last token this
        step if the installed injector says so (chaos runs only)."""
        inj = self.fault_injector
        if inj is None:
            return
        slot = inj.nan_slot()
        if slot is None or slot >= self.batch_size or not self.live[slot]:
            return
        self.last_logits[slot] = float("nan")
        self._set_token(slot, 0)

    def _set_token(self, slot: int, token: int) -> None:
        """Row ``slot``'s last token, written on the rank that holds it."""
        first, count = self.rows
        if first <= slot < first + count:
            self.state.last_token[slot - first] = int(token)

    def last_tokens(self) -> torch.Tensor:
        """Every row's last token, (B,) int32 on the device: under a
        batch split over the data axes gathered from the ranks (every
        rank calls it)."""
        if self.rows[1] == self.batch_size:
            return self.state.last_token
        return sl.gather_rows(self.layout, self.state.last_token,
                              self.batch_size)

    def decode_once(self):
        """One whole-batch decode step over the live rows.  Returns the
        (B,) last tokens as numpy, or None when no row is live.  Host
        mirrors advance only after the step ran, so a step that raises
        (``OutOfPages`` from the paged engine's in-step ``ensure``, an
        injected ``KernelLaunchError``) can be run again."""
        if not any(self.live):
            self.last_logits = None
            return None
        self._before_decode()
        dispatch = None
        if self.plan is not None:
            dispatch = self._demoted(self.plan.step_dispatch(
                [c for c, alive in zip(self.row_ctx, self.live) if alive]))
        elif self.cfg.attention == "mla":
            dispatch = self._demoted(self._latent_dispatch(
                1, 1 + max(c for c, alive in zip(self.row_ctx, self.live)
                           if alive)))
        self.last_dispatch = dispatch
        self.state, self.last_logits = decode_step(
            self.params, self.cfg, self.state, dispatch=dispatch,
            active=torch.tensor(self.live, device=self.device),
            block_tables=getattr(self.state, "block_tables", None),
            impl=self.impl, fsdp=self.layout)
        self._inject_nan()
        for i in range(self.batch_size):
            if self.live[i]:
                self.row_ctx[i] += 1
        return self.last_tokens().cpu().numpy()

    def step(self):
        """One scheduler step: advance every pending prefill by one
        chunk, then one whole-batch decode step.  Returns ``(tokens,
        inserted)``."""
        inserted = self._advance_prefills()
        return self.decode_once(), inserted

    def rollback_slot(self, slot: int, ctx: int, token: int) -> None:
        """Rewind row ``slot`` to a known-good (context, last token), the
        supervisor's quarantine primitive.  The rewound step's K/V write
        lies past the restored length, where the kernels never read it
        and a replay writes the same values.  A Mamba-2 layer's conv tail
        and SSM state cannot be rewound so (a decode step overwrites them
        in place), so a config with such layers raises."""
        ssm = [i for i in range(self.cfg.n_layers)
               if self.cfg.block_kind(i) != "attn"]
        if ssm:
            raise NotImplementedError(
                f"rollback_slot: layers {ssm} of {self.cfg.name} hold a "
                "conv tail and an SSM state that the decode step "
                "overwrote in place; rewinding cache_len alone would "
                "replay from the advanced state (the JAX engine does, "
                "and its tokens then differ from the fault-free run's)")
        self.state.cache_len[slot] = int(ctx)
        self._set_token(slot, token)
        self.row_ctx[slot] = int(ctx)

    def can_resume(self, pre: "PreemptedRequest") -> bool:
        """Dense rows are allocated up front: a snapshot can always
        re-enter a free slot (the paged engine checks its pages)."""
        return True

    def _row(self, t: torch.Tensor, axis: int, slot: int) -> torch.Tensor:
        """Row ``slot`` of the cache leaf ``t`` (batch along ``axis``):
        under a batch split over the data axes, every rank gets it from
        the rank that holds it (each rank's row at the same local index,
        gathered)."""
        first, count = self.rows
        if count == self.batch_size:
            return t.narrow(axis, slot, 1)
        mine = t.narrow(axis, slot % count, 1)
        every = sl.gather_rows(self.layout, mine, self.batch_size,
                               dim=axis)
        return every.narrow(axis, slot // count, 1)

    def preempt(self, slot: int) -> "PreemptedRequest":
        """Snapshot row ``slot``'s cache rows and position to host
        memory and free the lane: the dense twin of the paged engine's
        verb.  Under the sharded serving state the snapshot holds this
        rank's blocks of the row (and every rank gets the row from the
        rank that holds it)."""
        if not self.live[slot]:
            raise ValueError(f"slot {slot} is not live")
        kv = _map_leaves(self.state.cache, lambda t, axis: _host_copy(
            self._row(t, axis, slot)))
        pre = PreemptedRequest(
            kv=kv, n_pages=0, length=self.row_ctx[slot],
            last_token=int(self.last_tokens()[slot]))
        self.evict(slot)
        return pre

    def resume(self, pre: "PreemptedRequest", slot: int) -> None:
        """Re-admit a preempted snapshot into free slot ``slot``; the
        request continues bit for bit, with no prefill recompute."""
        if self.live[slot] or slot in self._pending:
            raise ValueError(f"slot {slot} is not free")
        cache = _map_leaves(pre.kv, lambda t, axis: t.to(self.device))
        self._insert(PrefillResult(cache=cache, length=pre.length,
                                   next_token=pre.last_token), slot)
        self.row_ctx[slot] = pre.length
        self.live[slot] = True

    def evict(self, slot: int) -> None:
        """Reclaim ``slot`` (request finished or cancelled)."""
        evict(self.state, slot, rows=self.rows)
        self.row_ctx[slot] = 0
        self.live[slot] = False


# ---------------------------------------------------------------------------
# paged KV: PageAllocator -> PagedDecodeState -> paged engine
# ---------------------------------------------------------------------------

class OutOfPages(RuntimeError):
    """The page pool cannot satisfy an allocation: the caller must
    preempt a live request (or wait for one to finish) first."""


class PageAllocator:
    """Host-side free-list allocator over a fixed KV page pool.

    Page 0 is a reserved null page: it is never handed out, so a zeroed
    block-table row (a dead batch lane) references it harmlessly; the
    kernels never read past a dead row's length 0.  Keys are arbitrary
    (the engine uses batch slot indices); ``pages[key]`` lists the key's
    page ids in row order, the prefix of its block-table row.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved "
                             "null page)")
        if page_size % 8:
            raise ValueError("page_size must be sublane-aligned (8)")
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() order 1, 2, 3, ...; page 0 never enters the free list
        self._free = list(range(num_pages - 1, 0, -1))
        self.pages: dict = {}             # key -> [page ids, row order]
        self.peak_used = 0
        #: bookkeeping oddities worth surfacing (a release of an
        #: already-released key): recorded, never raised
        self.notes: list = []
        #: the serving layer's fault injector (serve/faults.py): every
        #: alloc, and so every ensure that grows, consults it first
        self.fault_injector = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, key, n: int) -> list:
        """Append ``n`` fresh pages to ``key``'s list.  All or nothing:
        raises :class:`OutOfPages`, allocating none, when the free list
        is short."""
        if self.fault_injector is not None:
            self.fault_injector.on_alloc(key, n)
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages for {key!r} but only {len(self._free)} "
                f"of {self.num_pages - 1} are free — preempt or evict")
        ids = [self._free.pop() for _ in range(n)]
        self.pages.setdefault(key, []).extend(ids)
        self.peak_used = max(self.peak_used, self.used_pages)
        return ids

    def ensure(self, key, n_tokens: int) -> list:
        """Grow ``key``'s list to cover ``n_tokens`` entries; returns
        the newly allocated ids ([] when already covered)."""
        need = self.pages_for(n_tokens) - len(self.pages.get(key, []))
        return self.alloc(key, need) if need > 0 else []

    def release(self, key) -> list:
        """Free every page held by ``key``.  Idempotent: an unknown or
        already-released key returns ``[]`` and leaves a note, a
        scheduler bookkeeping smell worth surfacing and never worth
        killing the batch over."""
        if key not in self.pages:
            self.notes.append(
                f"release({key!r}): unknown or already-released key "
                f"(no-op)")
            return []
        ids = self.pages.pop(key)
        self._free.extend(reversed(ids))
        return ids


@dataclasses.dataclass
class PagedDecodeState:
    """DecodeState whose cache leaves are page pools
    ``(num_pages, Hkv, page, Dh)`` (the body's carry the leading
    ``n_periods`` axis) plus the ``(B, max_pages)`` int32 block table
    every layer shares."""
    cache: Any
    cache_len: torch.Tensor       # (B,) int32: per-row filled prefix
    last_token: torch.Tensor      # (B,) int32
    block_tables: torch.Tensor    # (B, max_pages) int32 page ids


@dataclasses.dataclass
class PreemptedRequest:
    """A preempted request's host snapshot: the gathered page contents
    per layer (the cache's {"prefix", "scan"} structure, attn leaves
    (n, Hkv, page, Dh) / (n_periods, n, ...); the dense engine's
    snapshot holds its B=1 cache rows with ``n_pages`` 0), its token
    position and last sampled token.  ``resume`` scatters it into
    freshly allocated pages: the KV bits are the same, so the
    continuation is the same."""
    kv: Any
    n_pages: int
    length: int
    last_token: int


def _check_paged_cfg(cfg: ModelConfig) -> None:
    """Page pools cover GQA attention caches only (the JAX package's
    refusals, with its messages)."""
    if cfg.attention == "mla":
        raise NotImplementedError(
            "paged KV is not supported for MLA latent caches")
    for i in range(cfg.n_layers):
        if cfg.block_kind(i) != "attn":
            raise NotImplementedError(
                "paged KV pools cover GQA attention caches only "
                f"(layer {i} is {cfg.block_kind(i)!r})")
    tf.check_ported(cfg)
    if sl.sharded_serving(cfg, active_mesh()):
        raise NotImplementedError(
            "paged KV does not compose with the distributed decode paths "
            "yet")


def init_paged_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                            num_pages: int, page_size: int,
                            dtype=torch.bfloat16,
                            device="cuda") -> PagedDecodeState:
    """Allocate the paged cache state: per-layer page pools plus one
    zeroed block table.  ``max_len`` bounds one row's context and fixes
    the table's width; the pool bounds the KV memory of all rows."""
    _check_paged_cfg(cfg)
    dev = resolve_device(device)
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} must be a multiple of the "
                         f"page size {page_size}")
    shape = (num_pages, cfg.kv_heads, page_size, cfg.head_dim)

    def layer(lead=()):
        return {"attn": {k: torch.zeros((*lead, *shape), dtype=dtype,
                                        device=dev) for k in ("k", "v")}}

    return PagedDecodeState(
        cache={"prefix": [layer() for _ in range(cfg.first_dense_layers)],
               "scan": [layer((cfg.n_periods,))
                        for _ in range(cfg.layer_period)]},
        cache_len=torch.zeros(batch, dtype=torch.int32, device=dev),
        last_token=torch.zeros(batch, dtype=torch.int32, device=dev),
        block_tables=torch.zeros((batch, max_len // page_size),
                                 dtype=torch.int32, device=dev))


def _pairs(cache, other):
    """(cache leaf, other leaf, scanned) over two trees of one
    structure."""
    for (a, axis), (b, _) in zip(_rows(cache), _rows(other)):
        yield a, b, axis == 1


def _page_chunks(dense_row: torch.Tensor, n: int, page: int):
    """(..., Hkv, max_len, Dh) dense rows -> their first n pages,
    (..., n, Hkv, page, Dh)."""
    *lead, hkv, _, dh = dense_row.shape
    return dense_row[..., :n * page, :].reshape(
        *lead, hkv, n, page, dh).movedim(-3, -4)


def _set_table_row(tables: torch.Tensor, slot: int, idx) -> None:
    """Zero row ``slot`` and write ``idx`` as its leading prefix."""
    tables[slot] = 0
    tables[slot, :len(idx)] = torch.as_tensor(idx, dtype=tables.dtype)


def insert_paged(state: PagedDecodeState, result: PrefillResult, slot: int,
                 page_ids: list) -> PagedDecodeState:
    """Scatter a dense B=1 prefill cache into pool pages, in place: each
    layer's (1, Hkv, max_len, Dh) rows are cut into page chunks written
    to ``page_ids``; the slot's block-table row becomes ``page_ids``
    (zero-padded).  Prefill itself stays dense: paging happens once,
    here, at admission."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=state.block_tables.device)
    n = len(page_ids)
    for pool, dense, scanned in _pairs(state.cache, result.cache):
        page = pool.shape[-2]
        if scanned:     # (n_periods, pages, ...) vs (n_periods, 1, ...)
            pool[:, idx] = _page_chunks(dense[:, 0], n, page).to(pool.dtype)
        else:
            pool[idx] = _page_chunks(dense[0], n, page).to(pool.dtype)
    state.cache_len[slot] = int(result.length)
    state.last_token[slot] = int(result.next_token)
    _set_table_row(state.block_tables, slot, page_ids)
    return state


def evict_paged(state: PagedDecodeState, slot: int) -> PagedDecodeState:
    """Free batch row ``slot``: zero its table row, position and token.
    The caller releases the pages on the allocator; the pool bits stay
    and are overwritten when the pages are next handed out."""
    state.cache_len[slot] = 0
    state.last_token[slot] = 0
    state.block_tables[slot] = 0
    return state


def gather_slot_pages(state: PagedDecodeState, page_ids: list):
    """The page contents backing one row, gathered from every layer's
    pool: fresh tensors on the pool's device (an index gather copies),
    which ``preempt`` moves to host memory."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=state.block_tables.device)
    return _map_leaves(state.cache,
                       lambda t, axis: t[:, idx] if axis else t[idx])


def resume_paged(state: PagedDecodeState, pre: PreemptedRequest, slot: int,
                 page_ids: list) -> PagedDecodeState:
    """Scatter a preempted request's KV snapshot into fresh pages and
    point the slot's table row at them, in place.  The pages differ,
    the bits do not: generation continues where preemption cut it."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=state.block_tables.device)
    for pool, saved, scanned in _pairs(state.cache, pre.kv):
        saved = saved.to(device=pool.device, dtype=pool.dtype)
        if scanned:
            pool[:, idx] = saved
        else:
            pool[idx] = saved
    state.cache_len[slot] = pre.length
    state.last_token[slot] = pre.last_token
    _set_table_row(state.block_tables, slot, page_ids)
    return state


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV cache.

    The dense engine's lifecycle and scheduler interface
    (``begin_prefill / step / evict``: ``RequestBatcher.serve`` drives
    both), over a page pool: ``begin_prefill`` reserves
    ``ceil((len + 1) / page)`` pages for the lease up front (so rows
    growing during a chunked prefill cannot drain the pool under it),
    the completed prefill scatters into the reserved pages, each decode
    step grows the page list of any live row crossing a page boundary,
    and eviction returns the pages to the free list.  Two more verbs:

    * ``preempt(slot)``: snapshot the row's pages and position to host
      memory, free the pages, clear the slot.  Costs one gather.
    * ``resume(pre, slot)``: re-admit a snapshot into fresh pages; the
      request continues bit for bit, with no prefill recompute.

    ``step_page_deficit()`` tells the scheduler how many pages short
    the next decode step would run: its cue to preempt before the
    in-step ``ensure`` raises :class:`OutOfPages`.
    """

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int,
                 page_size: int, num_pages: int,
                 max_len: Optional[int] = None, plan=None,
                 dtype=torch.float32, prefill_chunk: Optional[int] = None,
                 device="cuda"):
        self.page_size, self.num_pages = page_size, num_pages
        self.allocator = PageAllocator(num_pages, page_size)
        # monotone lease stamps: the scheduler preempts the newest lease
        # first (it has the least sunk prefill and decode work)
        self.lease_order = [0] * batch_size
        self._lease_clock = 0
        # host mirror of how many of each slot's pages the device block
        # table already indexes: a decode step retried after an
        # OutOfPages mid-loop re-derives exactly the table writes the
        # failed attempt never made
        self._table_pages = [0] * batch_size
        super().__init__(params, cfg, batch_size=batch_size,
                         max_len=max_len, plan=plan, dtype=dtype,
                         prefill_chunk=prefill_chunk, device=device)

    def _init_state(self):
        return init_paged_decode_state(
            self.cfg, self.batch_size, self.max_len,
            num_pages=self.num_pages, page_size=self.page_size,
            dtype=self.dtype, device=self.device)

    # -- page accounting ---------------------------------------------------

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Can a fresh ``n_tokens``-token prompt be admitted now?  It
        needs pages for the prompt plus its first decoded token."""
        return self.allocator.pages_for(n_tokens + 1) \
            <= self.allocator.num_free

    def can_resume(self, pre: PreemptedRequest) -> bool:
        """Can a preempted snapshot be re-admitted now?  It needs its
        saved pages back, and room for the next decoded token."""
        return max(pre.n_pages, self.allocator.pages_for(pre.length + 1)) \
            <= self.allocator.num_free

    def step_page_deficit(self) -> int:
        """Pages the next decode step needs beyond the free list (0
        when the step can run)."""
        need = sum(
            max(0, self.allocator.pages_for(self.row_ctx[i] + 1)
                - len(self.allocator.pages.get(i, [])))
            for i in range(self.batch_size) if self.live[i])
        return max(0, need - self.allocator.num_free)

    # -- lifecycle overrides -----------------------------------------------

    def begin_prefill(self, slot: int, prompt) -> None:
        """Lease ``slot`` and reserve the prompt's pages plus the first
        decoded token's (what ``can_admit_tokens`` checks).  The prefill
        runs on a dense side cache over the following steps; the
        reservation guarantees the pool can take the result however the
        live rows grow meanwhile."""
        super().begin_prefill(slot, prompt)
        try:
            self.allocator.alloc(
                slot, self.allocator.pages_for(len(prompt) + 1))
        except OutOfPages:
            del self._pending[slot]
            raise

    def _insert(self, res: PrefillResult, slot: int) -> None:
        insert_paged(self.state, res, slot, self.allocator.pages[slot])
        self._table_pages[slot] = len(self.allocator.pages[slot])
        self._lease_clock += 1
        self.lease_order[slot] = self._lease_clock

    def _before_decode(self) -> None:
        # Grow rows whose next token crosses into a new page.  Two
        # phases for retry safety: ``ensure`` may raise OutOfPages
        # mid-loop after earlier rows' allocations committed on the
        # allocator, so the device table and its host mirror are only
        # touched once every ensure has succeeded; a retry then sees
        # ``pages[i]`` ahead of ``_table_pages[i]`` and issues exactly
        # the writes the failed attempt never made.
        updates = []
        for i in range(self.batch_size):
            if not self.live[i]:
                continue
            self.allocator.ensure(i, self.row_ctx[i] + 1)
            ids = self.allocator.pages.get(i, [])
            if len(ids) != self._table_pages[i]:
                updates.append((i, self._table_pages[i],
                                ids[self._table_pages[i]:]))
        tbl = self.state.block_tables
        for i, start, new in updates:
            tbl[i, start:start + len(new)] = torch.as_tensor(
                new, dtype=tbl.dtype)
        for i, start, new in updates:
            self._table_pages[i] = start + len(new)

    def evict(self, slot: int) -> None:
        self.allocator.release(slot)
        evict_paged(self.state, slot)
        self.row_ctx[slot] = 0
        self.live[slot] = False
        self._table_pages[slot] = 0

    def preempt(self, slot: int) -> PreemptedRequest:
        """Save row ``slot``'s KV pages and position to host memory and
        free the slot (pages, table row, lane).  The snapshot is a host
        copy: the freed pages are overwritten in place once reissued."""
        if not self.live[slot]:
            raise ValueError(f"slot {slot} is not live")
        ids = list(self.allocator.pages[slot])
        kv = _map_leaves(gather_slot_pages(self.state, ids),
                         lambda t, axis: _host_copy(t))
        pre = PreemptedRequest(kv=kv, n_pages=len(ids),
                               length=self.row_ctx[slot],
                               last_token=int(self.state.last_token[slot]))
        self.evict(slot)
        return pre

    def resume(self, pre: PreemptedRequest, slot: int) -> None:
        """Re-admit a preempted snapshot into free slot ``slot``."""
        if self.live[slot] or slot in self._pending:
            raise ValueError(f"slot {slot} is not free")
        ids = self.allocator.alloc(slot, pre.n_pages)
        resume_paged(self.state, pre, slot, ids)
        self.row_ctx[slot] = pre.length
        self.live[slot] = True
        self._table_pages[slot] = len(ids)
        self._lease_clock += 1
        self.lease_order[slot] = self._lease_clock
