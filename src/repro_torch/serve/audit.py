"""Engine-state invariant auditor: a copy of ``repro/serve/audit.py``
over the port's torch state, whose ``cache_len`` and block tables are
read to the host once per call.

``audit(state, allocator, batcher)`` cross-checks the device state,
the host allocator and the scheduler against the invariants the whole
serving stack rests on, returning a list of human-readable violation
strings (empty = healthy).  It is cheap enough to run **every step**
in the chaos tests — the point being that fault *recovery* is only
trustworthy if the recovered state is provably self-consistent, not
just producing tokens.

Invariants:

* ``0 <= cache_len[b] <= max_len`` for every row;
* live rows ↔ allocator leases are a bijection (paged): every live or
  pending-prefill slot holds a lease, and no lease dangles;
* no page is leased twice (across keys or within one key's list);
* the free list is disjoint from every lease, never contains page 0,
  and free + leased accounts for the whole pool;
* block-table entries are within pool bounds, never the reserved null
  page 0, and each live row's table prefix lists *exactly* its lease;
* batcher slot bookkeeping matches (``slot_lens`` = prompt +
  generated of the leased request).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["audit", "audit_engine"]


def _host(state) -> tuple:
    """(cache_len, block tables or None) of ``state`` as numpy."""
    tables = getattr(state, "block_tables", None)
    return (state.cache_len.cpu().numpy(),
            None if tables is None else tables.cpu().numpy())


def audit(state, allocator=None, batcher=None, *,
          live: Optional[list] = None,
          pending: Optional[list] = None,
          max_len: Optional[int] = None) -> list:
    """Check serving invariants; returns violation strings (empty =
    healthy).  ``state`` is a DecodeState/PagedDecodeState; pass the
    engine's ``allocator`` (paged) and the driving ``batcher`` for the
    cross-structure checks.  ``live``/``pending``: the engine's host
    mirrors (slot index lists) for the lease-bijection check;
    ``max_len`` bounds ``cache_len``."""
    return _audit(*_host(state), allocator, batcher, live=live,
                  pending=pending, max_len=max_len)


def _audit(cache_len, tables, allocator, batcher, *, live, pending,
           max_len) -> list:
    bad: list = []
    batch = cache_len.shape[0]

    if (cache_len < 0).any():
        bad.append(f"cache_len negative: {cache_len.tolist()}")
    if max_len is not None and (cache_len > max_len).any():
        bad.append(f"cache_len exceeds max_len {max_len}: "
                   f"{cache_len.tolist()}")

    if allocator is not None:
        npages = allocator.num_pages
        free = list(allocator._free)
        leased: dict = {}               # page id -> key
        for key, ids in allocator.pages.items():
            seen: set = set()
            for p in ids:
                if p in seen:
                    bad.append(f"page {p} listed twice in lease "
                               f"{key!r}")
                seen.add(p)
                if p in leased:
                    bad.append(f"page {p} double-leased: {key!r} and "
                               f"{leased[p]!r}")
                leased[p] = key
                if not 0 < p < npages:
                    bad.append(f"lease {key!r} holds out-of-pool page "
                               f"{p} (pool is 1..{npages - 1})")
        if 0 in free:
            bad.append("reserved null page 0 on the free list")
        free_set = set(free)
        if len(free_set) != len(free):
            bad.append("free list contains duplicates")
        overlap = free_set & set(leased)
        if overlap:
            bad.append(f"pages both free and leased: {sorted(overlap)}")
        accounted = len(free_set | set(leased))
        if accounted != npages - 1:
            bad.append(f"page accounting leak: {accounted} of "
                       f"{npages - 1} pool pages are free or leased")

        if live is not None:
            expect = set(i for i in live) | set(pending or [])
            have = set(allocator.pages.keys())
            for k in sorted(have - expect, key=repr):
                bad.append(f"dangling lease {k!r}: no live row or "
                           f"pending prefill holds it")
            for k in sorted(expect - have, key=repr):
                bad.append(f"slot {k!r} is live/pending but holds no "
                           f"lease")

        if tables is not None:
            if (tables < 0).any() or (tables >= npages).any():
                bad.append("block-table entries outside the pool")
            for i in (live if live is not None else range(batch)):
                ids = allocator.pages.get(i, [])
                row = tables[i]
                if list(row[:len(ids)]) != list(ids):
                    bad.append(
                        f"row {i} table prefix {row[:len(ids)].tolist()}"
                        f" != lease {ids}")
                if (row[len(ids):] != 0).any():
                    bad.append(f"row {i} table past its lease is not "
                               f"null-page padding")
                if 0 in list(row[:len(ids)]):
                    bad.append(f"row {i} table prefix references the "
                               f"reserved null page 0")

    if batcher is not None:
        for i, req in enumerate(batcher.slots):
            if req is None:
                if batcher.slot_lens[i] != 0:
                    bad.append(f"batcher slot {i} free but slot_lens="
                               f"{batcher.slot_lens[i]}")
                continue
            want = len(req.prompt) + len(req.generated)
            if batcher.slot_lens[i] != want:
                bad.append(f"batcher slot {i} len {batcher.slot_lens[i]}"
                           f" != prompt+generated {want}")
            if live is not None and i not in live and \
                    pending is not None and i not in pending:
                bad.append(f"batcher slot {i} leased to request "
                           f"{req.uid} but engine row is neither live "
                           f"nor prefilling")
    return bad


def audit_engine(engine, batcher=None) -> list:
    """:func:`audit` with the engine's own host mirrors filled in —
    the strongest form of the check (lease bijection + table prefix
    verified against ``row_ctx``/``live``)."""
    live = [i for i, a in enumerate(engine.live) if a]
    pending = list(engine._pending.keys())
    cache_len, tables = _host(engine.state)
    bad = _audit(cache_len, tables, getattr(engine, "allocator", None),
                 batcher, live=live, pending=pending,
                 max_len=engine.max_len)
    for i in live:
        if int(cache_len[i]) != engine.row_ctx[i]:
            bad.append(f"row {i}: device cache_len {int(cache_len[i])}"
                       f" != host row_ctx {engine.row_ctx[i]}")
    return bad
