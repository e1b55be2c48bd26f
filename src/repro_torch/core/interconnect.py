"""Explicit core-to-core interconnect model (link/NoC layer).

The seed executor treated cross-core tensor movement as free: the GA
head->core allocation optimised against a machine model with zero
communication cost.  Stream (Symons et al.) schedules inter-core
transfers as first-class events, and Amirshahi et al. show
data-arrangement/communication dominates multi-core transformer
run-time — so the engine now books every cross-core tensor movement on
an explicit link with latency, energy and occupancy.

Two pieces:

* ``Interconnect`` — the immutable fabric description attached to an
  ``Accelerator``: per-link bandwidth (words/cycle), transfer energy
  (pJ/word), fixed per-transfer setup latency, and topology
  (``"ptp"``: a dedicated link per ordered core pair; ``"bus"``: one
  shared medium all transfers serialise on).
* ``LinkTimeline`` — the mutable per-run booking state owned by the
  event-driven executor: per-link busy/free times, total communication
  cycles/energy, and the transfer log.  Transfers are booked FIFO in
  commit order; a transfer starts at max(link free, data ready).

A copy of the JAX package's ``repro/core/interconnect.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Union

#: "bus" or an ordered (src_core, dst_core) pair.
LinkKey = Union[str, tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Immutable fabric description (attached to ``Accelerator``)."""

    bandwidth: float = 64.0        # words/cycle per link
    energy_per_word: float = 2.0   # pJ/word moved core-to-core
    latency: float = 0.0           # fixed setup cycles per transfer
    topology: str = "ptp"          # "ptp" | "bus"

    def __post_init__(self):
        if self.topology not in ("ptp", "bus"):
            raise ValueError(f"unknown topology {self.topology!r}")

    def link_key(self, src: int, dst: int) -> LinkKey:
        return "bus" if self.topology == "bus" else (src, dst)

    def transfer_cycles(self, words: int) -> float:
        return self.latency + words / self.bandwidth

    def transfer_energy(self, words: int) -> float:
        return words * self.energy_per_word


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One booked core-to-core tensor movement."""

    src: int
    dst: int
    tensor: str
    words: int
    start: float
    end: float
    energy_pj: float


class LinkTimeline:
    """Per-run link booking state (the engine owns one per evaluation)."""

    def __init__(self, fabric: Interconnect):
        self.fabric = fabric
        self._free: dict[LinkKey, float] = {}
        self._busy: dict[LinkKey, float] = {}
        self.comm_cycles = 0.0
        self.comm_energy_pj = 0.0
        self.transfers: list[Transfer] = []

    def free_time(self, src: int, dst: int) -> float:
        """When the (src, dst) link next becomes idle (for previews —
        candidate scoring must not mutate the timeline)."""
        return self._free.get(self.fabric.link_key(src, dst), 0.0)

    def book(self, src: int, dst: int, tensor: str, words: int,
             ready: float) -> Transfer:
        """Commit a transfer: occupy the link, account cycles/energy."""
        key = self.fabric.link_key(src, dst)
        start = max(self._free.get(key, 0.0), ready)
        dur = self.fabric.transfer_cycles(words)
        end = start + dur
        self._free[key] = end
        self._busy[key] = self._busy.get(key, 0.0) + dur
        self.comm_cycles += dur
        energy = self.fabric.transfer_energy(words)
        self.comm_energy_pj += energy
        tr = Transfer(src=src, dst=dst, tensor=tensor, words=words,
                      start=start, end=end, energy_pj=energy)
        self.transfers.append(tr)
        return tr

    def utilization(self, makespan: float) -> dict[LinkKey, float]:
        """Busy fraction per link over the schedule's makespan."""
        if makespan <= 0.0:
            return {k: 0.0 for k in self._busy}
        return {k: busy / makespan for k, busy in self._busy.items()}
