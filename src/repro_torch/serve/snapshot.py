"""Whole-engine snapshot and restore through ``checkpoint/manager.py``: a
port of ``repro/serve/snapshot.py``.

A serving crash loses three kinds of state at once: the device decode
state (caches, per-row positions, block tables), the host allocator
metadata (free list, leases), and the scheduler (queue, slot leases,
per-request progress).  :func:`snapshot_engine` writes all of it as ONE
checkpoint: the tensor leaves (engine state, every in-flight prefill's
side cache, every paused request's KV snapshot) go down as a flat leaf
list through ``CheckpointManager.save``; the host metadata rides in the
manifest's JSON ``extras`` with per-section leaf counts, so
:func:`restore_engine` reassembles everything from ``restore_flat``
without a like-structured tree.

Snapshots are taken between scheduler steps, where the invariants
:func:`~repro_torch.serve.audit.audit` checks all hold; restoring one
into a fresh engine, batcher and supervisor of the same geometry
resumes the stream bit for bit.  The engine's tensors come back on its
device; a paused request's KV stays in host memory, where ``preempt``
keeps it.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import transformer as tf
from repro_torch.serve.batcher import Request
from repro_torch.serve.engine import PreemptedRequest

__all__ = ["snapshot_engine", "restore_engine"]


def _req_to_dict(req: Request) -> dict:
    return {"uid": int(req.uid),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "generated": [int(t) for t in req.generated],
            "done": bool(req.done), "retries": int(req.retries),
            "failed": bool(req.failed)}


def _req_from_dict(d: dict) -> Request:
    return Request(uid=d["uid"], prompt=list(d["prompt"]),
                   max_new_tokens=d["max_new_tokens"],
                   generated=list(d["generated"]), done=d["done"],
                   retries=d.get("retries", 0),
                   failed=d.get("failed", False))


def snapshot_engine(mgr, step: int, engine, batcher, *,
                    supervisor=None, blocking: bool = True) -> None:
    """Write one crash-safe checkpoint holding the whole serving state:
    the engine's device state, in-flight prefill caches, paused
    requests' KV snapshots, the allocator's and scheduler's host
    metadata, and (optionally) the supervisor's counters."""
    state_leaves = tree.leaves(engine.state)
    flat = list(state_leaves)

    pending_meta = []
    for slot in sorted(engine._pending):
        p = engine._pending[slot]
        leaves = tree.leaves(p["cache"])
        flat.extend(leaves)
        pending_meta.append(
            {"slot": int(slot), "pos": int(p["pos"]),
             "tokens": p["tokens"][0].tolist(),
             "n_leaves": len(leaves)})

    queue_meta = []
    for req in batcher.queue:
        d = _req_to_dict(req)
        if req.paused is not None:
            leaves = tree.leaves(req.paused.kv)
            flat.extend(leaves)
            d["paused"] = {"n_pages": int(req.paused.n_pages),
                           "length": int(req.paused.length),
                           "last_token": int(req.paused.last_token),
                           "n_leaves": len(leaves)}
        queue_meta.append(d)

    extras = {
        "serving_snapshot": 1,
        "kind": "paged" if getattr(engine, "allocator", None)
                is not None else "dense",
        "state_leaves": len(state_leaves),
        "row_ctx": [int(c) for c in engine.row_ctx],
        "live": [bool(a) for a in engine.live],
        "pending": pending_meta,
        "queue": queue_meta,
        "slots": [_req_to_dict(r) if r is not None else None
                  for r in batcher.slots],
        "slot_lens": [int(n) for n in batcher.slot_lens],
        "finished": [_req_to_dict(r) for r in batcher.finished],
    }
    alloc = getattr(engine, "allocator", None)
    if alloc is not None:
        extras["allocator"] = {
            "free": [int(p) for p in alloc._free],
            "pages": {str(k): [int(p) for p in v]
                      for k, v in alloc.pages.items()},
            "peak_used": int(alloc.peak_used),
            "notes": list(alloc.notes)}
        extras["lease_order"] = [int(x) for x in engine.lease_order]
        extras["lease_clock"] = int(engine._lease_clock)
    if supervisor is not None:
        extras["supervisor"] = supervisor.state_dict()
        extras["failed"] = [_req_to_dict(r)
                            for r in supervisor.failed]
    mgr.save(step, flat, extras=extras, blocking=blocking)


def restore_engine(mgr, engine, batcher,
                   step: Optional[int] = None,
                   supervisor=None) -> dict:
    """Reload a :func:`snapshot_engine` checkpoint into a freshly
    constructed engine and batcher (the snapshotted ones' config and
    geometry).  Returns the checkpoint extras."""
    leaves, extras = mgr.restore_flat(step)
    if extras.get("serving_snapshot") != 1:
        raise ValueError("checkpoint is not a serving snapshot")
    pos = 0

    def take(n, device=None):
        nonlocal pos
        out, pos = leaves[pos:pos + n], pos + n
        return [t.to(device) if device is not None else t for t in out]

    dev = engine.device
    engine.state = tree.unflatten(engine.state,
                                  take(extras["state_leaves"], dev))
    engine.row_ctx = list(extras["row_ctx"])
    engine.live = list(extras["live"])
    engine._insert_backlog = []
    engine.last_logits = None
    engine.prefill_logits = {}

    # in-flight prefills: side caches share the dense B=1 structure
    side = tf.init_model_cache(engine.cfg, 1, engine.max_len, engine.dtype,
                               "meta")
    engine._pending = {}
    for pm in extras["pending"]:
        cache = tree.unflatten(side, take(pm["n_leaves"], dev))
        engine._pending[pm["slot"]] = {
            "tokens": torch.tensor([pm["tokens"]], dtype=torch.long,
                                   device=dev),
            "pos": pm["pos"], "cache": cache}

    # batcher queue (paused KV snapshots share the cache structure and
    # stay in host memory)
    queue = deque()
    for d in extras["queue"]:
        req = _req_from_dict(d)
        if "paused" in d:
            pm = d["paused"]
            req.paused = PreemptedRequest(
                kv=tree.unflatten(engine.state.cache, take(pm["n_leaves"])),
                n_pages=pm["n_pages"], length=pm["length"],
                last_token=pm["last_token"])
        queue.append(req)
    batcher.queue = queue
    batcher.slots = [_req_from_dict(d) if d is not None else None
                     for d in extras["slots"]]
    batcher.slot_lens = list(extras["slot_lens"])
    batcher.finished = [_req_from_dict(d)
                        for d in extras["finished"]]

    alloc = getattr(engine, "allocator", None)
    if alloc is not None:
        am = extras["allocator"]
        alloc._free = list(am["free"])
        alloc.pages = {int(k): list(v) for k, v in am["pages"].items()}
        alloc.peak_used = am["peak_used"]
        alloc.notes = list(am["notes"])
        engine.lease_order = list(extras["lease_order"])
        engine._lease_clock = extras["lease_clock"]
        # between steps the device table prefix tracks the lease list
        # exactly (snapshots are only taken there), so the mirror is
        # each live row's lease length
        engine._table_pages = [
            len(alloc.pages.get(i, [])) if engine.live[i] else 0
            for i in range(engine.batch_size)]

    if supervisor is not None and "supervisor" in extras:
        supervisor.load_state_dict(extras["supervisor"])
        supervisor.failed = [_req_from_dict(d)
                             for d in extras.get("failed", [])]
    return extras
