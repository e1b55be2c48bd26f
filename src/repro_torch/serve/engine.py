"""Dense continuous-batching serving (a port of
``repro/serve/engine.py:76-556``).

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

Unlike the JAX engine, state is updated in place: the KV caches are
written by the model's appends, and ``insert``/``evict`` write the
slot's rows, length and token into the batch state's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.lower import serving_plan
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, resolve_device


@dataclasses.dataclass
class DecodeState:
    cache: Any
    cache_len: torch.Tensor       # (B,) int32: per-row filled prefix
    last_token: torch.Tensor      # (B,) int32


def make_serving_plan(cfg: ModelConfig, max_len: int, *, device="cuda"):
    """The ServingPlan for ``cfg`` on ``device``."""
    return serving_plan(cfg, max_len, device=device)


def init_decode_state(cfg: ModelConfig, batch: int,
                      max_len: Optional[int] = None,
                      dtype=torch.bfloat16, *, plan=None,
                      device="cuda") -> DecodeState:
    """Allocate the cache state; ``max_len`` may come from the plan."""
    dev = resolve_device(device)
    if max_len is None:
        if plan is None:
            raise TypeError("init_decode_state: pass max_len or a plan")
        max_len = plan.max_len
    if plan is not None and max_len > plan.max_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds the plan's {plan.max_len}: "
            "contexts past the last plan bucket would be unplanned")
    return DecodeState(
        cache=tf.init_model_cache(cfg, batch, max_len, dtype, dev),
        cache_len=torch.zeros(batch, dtype=torch.int32, device=dev),
        last_token=torch.zeros(batch, dtype=torch.int32, device=dev))


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(-1).to(torch.int32)


def prefill(params, cfg: ModelConfig, tokens, state: DecodeState, *,
            plan=None) -> DecodeState:
    """Run the whole prompt at once, filling the caches."""
    dispatch = None if plan is None else plan.prefill_dispatch(
        tokens.shape[1])
    logits, cache = tf.forward(params, cfg, tokens, cache=state.cache,
                               cache_len=0, plan=dispatch)
    return DecodeState(cache=cache,
                       cache_len=torch.full_like(state.cache_len,
                                                 tokens.shape[1]),
                       last_token=greedy_sample(logits))


def chunked_prefill(params, cfg: ModelConfig, tokens, state: DecodeState,
                    *, chunk_size: int, plan=None) -> DecodeState:
    """Prefill in ``chunk_size``-token chunks, re-resolving the plan per
    chunk: the first chunk is plain prefill, later chunks the KV-cached
    regime."""
    s = tokens.shape[1]
    cache, logits = state.cache, None
    for start in range(0, s, chunk_size):
        piece = tokens[:, start:start + chunk_size]
        dispatch = None if plan is None else plan.chunk_dispatch(
            start + piece.shape[1], piece.shape[1])
        logits, cache = tf.forward(params, cfg, piece, cache=cache,
                                   cache_len=start, plan=dispatch)
    return DecodeState(cache=cache,
                       cache_len=torch.full_like(state.cache_len, s),
                       last_token=greedy_sample(logits))


def decode_step(params, cfg: ModelConfig, state: DecodeState, *,
                plan=None, dispatch=None, active=None):
    """One token for every row.  ``dispatch``: a pre-resolved
    PlanDispatch (``ServingPlan.step_dispatch`` over host-side lengths),
    else resolved from ``plan`` and the state.  ``active``: (B,) bool;
    rows where it is False keep their length and last token.  Returns
    (new state, last-position logits (B, vocab))."""
    if dispatch is None and plan is not None:
        dispatch = plan.decode_dispatch(
            plan.concrete_ctx(state.cache_len) + 1)
    logits, cache = tf.forward(params, cfg, state.last_token[:, None],
                               cache=state.cache,
                               cache_len=state.cache_len, plan=dispatch)
    nxt = greedy_sample(logits)
    step = torch.ones_like(state.cache_len)
    if active is not None:
        act = torch.as_tensor(active, device=nxt.device)
        nxt = torch.where(act, nxt, state.last_token)
        step = act.to(state.cache_len.dtype)
    return DecodeState(cache=cache, cache_len=state.cache_len + step,
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
    """Prefill one request on the side (B=1) for ``insert``."""
    dev = resolve_device(device)
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                           device=dev).reshape(1, -1)
    state = init_decode_state(cfg, 1, max_len, dtype, plan=plan,
                              device=dev)
    if chunk_size is None:
        state = prefill(params, cfg, toks, state, plan=plan)
    else:
        state = chunked_prefill(params, cfg, toks, state,
                                chunk_size=chunk_size, plan=plan)
    return PrefillResult(cache=state.cache, length=toks.shape[1],
                         next_token=int(state.last_token[0]))


def _rows(cache):
    """(cache leaf, its batch axis) pairs: batch is axis 0 of
    prefix-layer caches and axis 1 of the stacked body."""
    for layer in cache["prefix"]:
        for t in layer["attn"].values():
            yield t, 0
    for layer in cache["scan"]:
        for t in layer["attn"].values():
            yield t, 1


def insert(state: DecodeState, result: PrefillResult,
           slot: int) -> DecodeState:
    """Write a prefilled request into batch row ``slot`` (cache rows,
    write position, last token), in place; other rows are untouched."""
    for (full, axis), (row, _) in zip(_rows(state.cache),
                                      _rows(result.cache)):
        full.select(axis, slot).copy_(row.select(axis, 0))
    state.cache_len[slot] = result.length
    state.last_token[slot] = result.next_token
    return state


def evict(state: DecodeState, slot: int) -> DecodeState:
    """Free batch row ``slot``: zero its write position and token.  The
    KV rows stay; the next insert into the slot overwrites them."""
    state.cache_len[slot] = 0
    state.last_token[slot] = 0
    return state


class ContinuousBatchingEngine:
    """The ``init_decode_state -> prefill -> insert -> generate``
    lifecycle as one object: a fixed-geometry decode batch whose rows
    are leased to requests and reclaimed as they finish, with new
    requests prefilled (chunk by chunk with ``prefill_chunk``) and
    inserted mid-stream.  Host mirrors (``row_ctx``, ``live``) let each
    step's plan be resolved from the live rows' contexts without
    reading device memory."""

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int,
                 max_len: Optional[int] = None, plan=None,
                 dtype=torch.float32, prefill_chunk: Optional[int] = None,
                 device="cuda"):
        if max_len is None:
            if plan is None:
                raise TypeError(
                    "ContinuousBatchingEngine: pass max_len or a plan")
            max_len = plan.max_len
        self.params, self.cfg, self.plan = params, cfg, plan
        self.batch_size, self.max_len = batch_size, max_len
        self.dtype, self.device = dtype, resolve_device(device)
        self.prefill_chunk = prefill_chunk
        self.state = init_decode_state(cfg, batch_size, max_len, dtype,
                                       plan=plan, device=self.device)
        self.row_ctx = [0] * batch_size   # host mirror of cache_len
        self.live = [False] * batch_size
        self._pending: dict = {}          # slot -> in-flight prefill
        #: the last decode step's last-position logits (B, vocab), on
        #: the device; the last prefill chunk's, per slot
        self.last_logits: Optional[torch.Tensor] = None
        self.prefill_logits: dict = {}

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
        side = tf.init_model_cache(self.cfg, 1, self.max_len, self.dtype,
                                   self.device)
        self._pending[slot] = {"tokens": toks, "pos": 0, "cache": side}

    def _advance_prefills(self) -> list:
        """One prefill chunk per pending request; insert the ones that
        complete.  Returns [(slot, first_token), ...]."""
        inserted = []
        for slot, p in list(self._pending.items()):
            total = p["tokens"].shape[1]
            chunk = self.prefill_chunk or total
            piece = p["tokens"][:, p["pos"]:p["pos"] + chunk]
            dispatch = None
            if self.plan is not None:
                dispatch = self.plan.chunk_dispatch(
                    p["pos"] + piece.shape[1], piece.shape[1])
            logits, p["cache"] = tf.forward(
                self.params, self.cfg, piece, cache=p["cache"],
                cache_len=p["pos"], plan=dispatch)
            p["pos"] += piece.shape[1]
            if p["pos"] >= total:
                self.prefill_logits[slot] = logits[0, -1]
                res = PrefillResult(cache=p["cache"], length=total,
                                    next_token=int(greedy_sample(logits)[0]))
                insert(self.state, res, slot)
                self.row_ctx[slot] = total
                self.live[slot] = True
                del self._pending[slot]
                inserted.append((slot, res.next_token))
        return inserted

    def decode_once(self):
        """One whole-batch decode step over the live rows.  Returns the
        (B,) last tokens as numpy, or None when no row is live."""
        if not any(self.live):
            self.last_logits = None
            return None
        dispatch = None
        if self.plan is not None:
            dispatch = self.plan.step_dispatch(
                [c for c, alive in zip(self.row_ctx, self.live) if alive])
        self.state, self.last_logits = decode_step(
            self.params, self.cfg, self.state, dispatch=dispatch,
            active=torch.tensor(self.live, device=self.device))
        for i in range(self.batch_size):
            if self.live[i]:
                self.row_ctx[i] += 1
        return self.state.last_token.cpu().numpy()

    def step(self):
        """One scheduler step: advance every pending prefill by one
        chunk, then one whole-batch decode step.  Returns ``(tokens,
        inserted)``."""
        inserted = self._advance_prefills()
        return self.decode_once(), inserted

    def evict(self, slot: int) -> None:
        """Reclaim ``slot`` (request finished or cancelled)."""
        evict(self.state, slot)
        self.row_ctx[slot] = 0
        self.live[slot] = False
