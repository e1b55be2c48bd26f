"""Per-node cost model for the Stream-class engine (paper Sec. II.B step 3).

The seed inlined the latency/energy formulas inside the Step-5 executor;
this module lifts them behind a small ``CostModel`` protocol so that

* the event-driven executor (``core/engine.py``) evaluates nodes through
  an injectable model,
* alternative models (measured lookup tables, learned predictors,
  per-layer calibrations) can be swapped in without touching the
  scheduler, and
* the closed-form roofline/traffic helpers used by ``core/codesign.py``
  and ``benchmarks/roofline.py`` live next to the node formulas instead
  of being re-derived in each consumer.

``AnalyticalCostModel`` reproduces the seed formulas bit-for-bit: the
executor's results must not change for single-core schedules (the
regression tests in ``tests/test_core_engine.py`` pin this).

A copy of the JAX package's ``repro/core/costmodel.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core import nodes as cn
from repro_torch.core import workload as wl
from repro_torch.core.accelerator import Accelerator, Core


class IllegalSchedule(Exception):
    """Raised when a schedule violates the dependency rules of Step 2,
    or asks for a resource the platform does not have."""


@runtime_checkable
class CostModel(Protocol):
    """Per-computation-node latency/energy estimator.

    ``streamed_in`` / ``streamed_out`` flag operands forwarded through
    register files (layer fusion) that therefore skip the L1 round-trip.
    """

    def node_latency(self, node: cn.ComputationNode, layer: wl.Layer,
                     core: Core, streamed_in: bool,
                     streamed_out: bool) -> float: ...

    def node_energy(self, node: cn.ComputationNode, layer: wl.Layer,
                    core: Core, streamed_in: bool,
                    streamed_out: bool) -> tuple[float, int]: ...


class AnalyticalCostModel:
    """The paper's analytical model: latency = max(compute, memory)
    cycles; energy = MAC/SIMD op energy + L1/L2 word traffic."""

    def node_latency(self, node: cn.ComputationNode, layer: wl.Layer,
                     core: Core, streamed_in: bool,
                     streamed_out: bool) -> float:
        """max(compute, memory) cycles for one node (Sec. II.B step 3)."""
        if node.simd:
            if core.simd is None:
                raise IllegalSchedule(f"{node} needs a SIMD unit")
            return max(node.vector_ops / core.simd.width, 1.0)
        compute = node.macs / core.effective_macs_per_cycle
        # memory movement (skip streamed operands: register-file forwarding)
        io_words = 0
        rhs_idx = getattr(core, "rhs_level_index", 0)
        if isinstance(layer, wl.MatMul):
            if not streamed_in and layer.i1 != wl.WEIGHT:
                io_words += node.n_rows * layer.s
            if not streamed_out:
                io_words += node.n_rows * layer.cols
            rhs_words = layer.s * layer.cols  # right operand, multi-banked
            if layer.i2 == wl.KVCACHE:
                # the N_ctx-deep cache streams from the top memory
                # level, not the multi-banked L1 — decode latency is
                # cache-bandwidth bound, which is the phase asymmetry
                # the schedule selector exploits
                rhs_idx = len(core.levels) - 1
        else:
            io_words = 0 if streamed_in else node.n_rows * layer.cols
            rhs_words = 0
        io_bw = core.levels[0].bandwidth
        rhs_bw = core.levels[min(rhs_idx, len(core.levels) - 1)].bandwidth
        mem = max(io_words / io_bw, rhs_words / rhs_bw if rhs_words else 0.0)
        return max(compute, mem, 1.0)

    def node_energy(self, node: cn.ComputationNode, layer: wl.Layer,
                    core: Core, streamed_in: bool,
                    streamed_out: bool) -> tuple[float, int]:
        """(energy_pj, feature_l1_words_touched) for one node."""
        l1 = core.levels[0]
        upper = core.levels[1] if len(core.levels) > 1 else core.levels[0]
        e = node.macs * core.mac_energy
        if core.simd is not None:
            e += node.vector_ops * core.simd.op_energy
        feat_words = 0
        if isinstance(layer, wl.MatMul):
            if layer.i1 != wl.WEIGHT and not streamed_in:
                feat_words += node.n_rows * layer.s
            if layer.i2 == wl.WEIGHT:
                # weights fetched once per layer from the upper level
                e += (layer.s * layer.cols / max(layer.rows, 1)) \
                    * node.n_rows * upper.read_energy
            elif layer.i2 == wl.KVCACHE:
                # cached K/V fetched once per layer from the top level
                # (persistent memory, not active features)
                e += (layer.s * layer.cols / max(layer.rows, 1)) \
                    * node.n_rows * core.levels[-1].read_energy
            else:
                feat_words += layer.s * layer.cols  # feature rhs re-read
        elif not streamed_in:
            feat_words += node.n_rows * layer.cols
        if not streamed_out:
            feat_words += node.n_rows * layer.cols
        e += feat_words * l1.read_energy
        return e, feat_words


#: Shared default instance (the model is stateless).
DEFAULT = AnalyticalCostModel()


# ---------------------------------------------------------------------------
# Closed-form helpers shared with codesign / roofline
# ---------------------------------------------------------------------------

def compute_seconds(flops: float, peak_flops: float) -> float:
    """Compute roofline term in seconds (device-level units)."""
    return flops / peak_flops


def hw_constants(accel: Accelerator, word_bytes: int = 2) -> dict:
    """Device-level roofline constants derived from an ``Accelerator``
    description (single source of truth instead of a parallel HW table):
    peak FLOP/s (2 FLOP per MAC), HBM and inter-chip bandwidths in B/s."""
    core = accel.core(0)
    freq = accel.frequency_hz
    return {
        "peak_flops": 2.0 * core.effective_macs_per_cycle * freq,
        "hbm_bw": accel.offchip_bandwidth * freq * word_bytes,
        "ici_bw": accel.interconnect_bandwidth * freq * word_bytes,
    }


def attention_hbm_traffic(M: int, N: int, dtype_bytes: int = 2, *,
                          fused: bool) -> int:
    """Off-chip bytes for one M x N attention head's score path.

    Unfused (layer-by-layer): the M x M score matrix is written then read
    back (the paper's stored intermediate).  Fused (Fig. 5c analogue):
    the score matrix never leaves the on-chip feature memory.
    """
    qkv = 3 * M * N * dtype_bytes
    out = M * N * dtype_bytes
    if fused:
        return qkv + out
    return 2 * M * M * dtype_bytes + qkv + out
