"""Token data pipeline of the port: a copy of ``repro/data/pipeline.py``
(numpy only), so both packages give the same tokens for the same
(seed, step).  Deterministic, host-sharded, resumable.

Two sources behind one iterator protocol:

* SyntheticTokenDataset — counter-hashed tokens (splitmix64), fully
  deterministic in (seed, step, host): any step's batch can be
  regenerated after a restart without replaying the stream.
* MemmapTokenDataset — flat binary token file via np.memmap, strided by
  (host, step); the file-backed path.

``make_batch_iterator`` adds host sharding (each host materialises only
its rows), background prefetch, and a state dict {step} for exact
checkpoint/resume: data state is one integer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class SyntheticTokenDataset:
    """Deterministic pseudo-text: batch(step) is a pure function.

    ``structured=True`` emits learnable sequences (modular arithmetic
    progressions whose stride is inferable from the first two tokens) —
    used by convergence tests/examples; the default is uniform-hash
    tokens (throughput/benchmark mode)."""

    def __init__(self, vocab_size: int, seq_len: int,
                 global_batch: int, seed: int = 0,
                 structured: bool = False):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structured = structured

    def batch(self, step: int, row_start: int = 0,
              rows: Optional[int] = None) -> np.ndarray:
        rows = rows if rows is not None else self.global_batch
        idx = (np.uint64(self.seed) * np.uint64(0x100000001B3)
               + np.uint64(step) * np.uint64(self.global_batch
                                             * (self.seq_len + 1)))
        if self.structured:
            row_ids = idx + np.uint64(row_start) \
                + np.arange(rows, dtype=np.uint64)
            start = _splitmix64(row_ids) % np.uint64(self.vocab_size)
            stride = _splitmix64(row_ids ^ np.uint64(0xABCD)) \
                % np.uint64(max(self.vocab_size // 8, 1)) + np.uint64(1)
            pos = np.arange(self.seq_len + 1, dtype=np.uint64)
            toks = (start[:, None] + stride[:, None] * pos[None, :]) \
                % np.uint64(self.vocab_size)
            return toks.astype(np.int32)
        base = np.arange(rows * (self.seq_len + 1), dtype=np.uint64)
        base += idx + np.uint64(row_start * (self.seq_len + 1))
        toks = _splitmix64(base) % np.uint64(self.vocab_size)
        return toks.astype(np.int32).reshape(rows, self.seq_len + 1)


class MemmapTokenDataset:
    """Flat int32 token file; batch(step) strides deterministically."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 global_batch: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.n_windows = len(self.tokens) // (seq_len + 1)

    def batch(self, step: int, row_start: int = 0,
              rows: Optional[int] = None) -> np.ndarray:
        rows = rows if rows is not None else self.global_batch
        w = self.seq_len + 1
        out = np.empty((rows, w), np.int32)
        for r in range(rows):
            win = (step * self.global_batch + row_start + r) \
                % self.n_windows
            out[r] = self.tokens[win * w:(win + 1) * w]
        return out % self.vocab_size


def make_batch_iterator(dataset, *, host_id: int = 0, n_hosts: int = 1,
                        start_step: int = 0, prefetch: int = 2
                        ) -> Iterator[tuple[int, np.ndarray]]:
    """Host-sharded, prefetching, resumable iterator yielding
    (step, host_local_rows).  Resume = pass the checkpointed step."""
    rows_per_host = dataset.global_batch // n_hosts
    row_start = host_id * rows_per_host

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            b = dataset.batch(step, row_start, rows_per_host)
            q.put((step, b))
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass

        def state_dict(self, last_step: int):
            return {"step": last_step + 1}

    return _Iter()
