"""Hardware architecture descriptions for the Stream-class analytical engine.

The paper (Sec. II.B, III, IV.A) evaluates schedules on parameterised
multi-core accelerators: each core has a PE array, a private memory
hierarchy, and optionally a SIMD unit beside the array (used for softmax).

We keep the description deliberately analytical (counts, bandwidths,
energies) — this is a cost model, not a simulator.  Three factory
configurations are provided:

* ``gap8()``               — the Sec. III validation platform (8 cores x 1 MAC,
                             L2->L1 DMA with 51 bit/cycle effective bandwidth).
* ``pe_array_64x64()``     — the Sec. IV exploration platform (single core,
                             64x64 PE array + SIMD softmax core, dual L1).
* ``tpu_v5e_like()``       — the JAX package's TPU co-design platform
                             (128x128 MXU, VMEM/HBM hierarchy).

Every platform here is a DSE input modelled on the hardware it names;
none of them describes the H100 the port's kernels run on.

A copy of the JAX package's ``repro/core/accelerator.py`` with its names and
arithmetic unchanged, so that the port's results are bit-equal to
the reference's; the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.interconnect import Interconnect


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of a core's memory hierarchy.

    ``bandwidth`` is in words/cycle towards the compute units; energies are
    in (arbitrary but consistent) pJ/word.  ``size`` in words;
    ``size=None`` means unbounded (off-chip).
    """

    name: str
    size: Optional[int]
    bandwidth: float
    read_energy: float = 1.0
    write_energy: float = 1.0

    def scaled_access_energy(self, occupied_words: int) -> float:
        """SRAM access energy grows ~sqrt(capacity); the paper notes that a
        smaller *required* feature memory lets a designer instantiate a
        smaller, cheaper memory (Sec. IV.C.3).  We expose that effect as an
        optional scaling relative to the level's nominal size."""
        if not self.size or occupied_words <= 0:
            return self.read_energy
        frac = max(occupied_words / self.size, 1e-6)
        return self.read_energy * math.sqrt(frac)


@dataclasses.dataclass(frozen=True)
class SIMDUnit:
    """Vector unit beside the PE array (paper: 'a small SIMD core is placed
    in parallel with the 64x64 core to compute the output of the softmax')."""

    width: int = 64                # elements / cycle
    op_energy: float = 0.2        # pJ / element-op


@dataclasses.dataclass(frozen=True)
class Core:
    """A single accelerator core: PE array + memory hierarchy (+ SIMD)."""

    name: str
    array_rows: int               # spatial unroll capacity, dim 1 (S)
    array_cols: int               # spatial unroll capacity, dim 2 (T)
    mac_energy: float = 1.0       # pJ / MAC
    macs_per_pe_per_cycle: float = 1.0
    # Effective sustained throughput derate (loop overhead, load/drain,
    # requantisation...).  Calibrated against hardware for GAP8 (Sec. III).
    utilization: float = 1.0
    levels: tuple[MemoryLevel, ...] = ()
    simd: Optional[SIMDUnit] = None
    # index into ``levels`` feeding the array's right operand (the paper's
    # multi-banked L1 for I2 on the 64x64 platform)
    rhs_level_index: int = 0

    @property
    def peak_macs_per_cycle(self) -> float:
        return self.array_rows * self.array_cols * self.macs_per_pe_per_cycle

    @property
    def effective_macs_per_cycle(self) -> float:
        return self.peak_macs_per_cycle * self.utilization

    def l1(self) -> MemoryLevel:
        """Innermost shared level that holds active feature data."""
        return self.levels[0]


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """A (possibly heterogeneous) multi-core platform."""

    name: str
    cores: tuple[Core, ...]
    # words/cycle between cores (core-to-core feature handoff)
    interconnect_bandwidth: float = 64.0
    offchip_bandwidth: float = 8.0
    frequency_hz: float = 100e6
    # explicit link/NoC model; None -> a default point-to-point fabric
    # derived from ``interconnect_bandwidth`` (see ``fabric()``)
    interconnect: Optional[Interconnect] = None

    def core(self, idx: int) -> Core:
        return self.cores[idx]

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    def fabric(self) -> Interconnect:
        """The core-to-core interconnect the executor books transfers on."""
        if self.interconnect is not None:
            return self.interconnect
        return Interconnect(bandwidth=self.interconnect_bandwidth)


# ---------------------------------------------------------------------------
# Factory configurations
# ---------------------------------------------------------------------------

def gap8(utilization: float = 0.444) -> Accelerator:
    """GAP8 (Sec. III): 8 RISC-V cores, 1 MAC each, 4-level memory (L3..L0).

    The L2->L1 interface is 64-bit wide but configuration and packet
    overhead reduce it to an effective 51 bits/cycle (paper, Sec. III);
    at 8-bit precision that is ~6.4 words/cycle.

    ``utilization`` is the calibrated sustained-MAC derate of the cluster
    executing the I-BERT integer kernels of [19].  The paper's own Stream
    model is calibrated the same way (its estimate lands 8-9% *below* the
    hardware measurement); utilization=0.444 (i.e. ~3.55 sustained
    MAC/cycle across the cluster) reproduces the published model estimates
    of 1.692/3.540 MCycles for seq 81/128 (see core/validation.py, which
    asserts both numbers and both deviations vs the 1.836/3.905 MCycle
    hardware measurements).  A single constant fits BOTH sequence lengths
    because the modelled cycle count is proportional to the exact MHSA MAC
    count 24576*M + 512*M^2 + 8192*M, whose 128:81 ratio (2.092) equals the
    ratio of the paper's two published estimates.
    """
    levels = (
        MemoryLevel("L1", size=64 * 1024, bandwidth=16.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L2", size=512 * 1024, bandwidth=51.0 / 8.0,
                    read_energy=6.0, write_energy=7.0),
        MemoryLevel("L3", size=None, bandwidth=1.0,
                    read_energy=60.0, write_energy=70.0),
    )
    # Model the 8-core cluster as one core with an 8-wide "array" (the
    # cluster parallelises one loop dim over cores), 1 MAC per core.
    cluster = Core(
        name="gap8-cluster",
        array_rows=8, array_cols=1,
        mac_energy=0.5,
        utilization=utilization,
        levels=levels,
        simd=SIMDUnit(width=8, op_energy=0.1),
    )
    return Accelerator(
        name="GAP8", cores=(cluster,),
        interconnect_bandwidth=51.0 / 8.0,
        offchip_bandwidth=1.0,
        frequency_hz=100e6,
        # the cluster shares one L2 TCDM bus; transfers serialise on it
        interconnect=Interconnect(bandwidth=51.0 / 8.0, energy_per_word=6.0,
                                  latency=16.0, topology="bus"),
    )


def pe_array_64x64(l1_io_words: int = 1 << 22) -> Accelerator:
    """Sec. IV exploration platform.

    'a single core hardware architecture with a 64x64 array of processing
    elements ... two L1 memories: one for the left input matrix and output
    matrix (bandwidth of 64 words), and one for the right input matrix with
    a multi-banked bandwidth of 4096 words.  A small SIMD core is placed in
    parallel with the 64x64 core to compute the output of the softmax.'
    """
    levels = (
        # L1-io: left inputs + outputs (+ features waiting between layers).
        MemoryLevel("L1-io", size=l1_io_words, bandwidth=64.0,
                    read_energy=1.0, write_energy=1.2),
        # L1-w: right operand, multi-banked.
        MemoryLevel("L1-rhs", size=l1_io_words, bandwidth=4096.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L2", size=None, bandwidth=64.0,
                    read_energy=8.0, write_energy=9.0),
    )
    core = Core(
        name="pe64x64",
        array_rows=64, array_cols=64,
        mac_energy=1.0,
        utilization=1.0,
        levels=levels,
        simd=SIMDUnit(width=128, op_energy=0.2),
        rhs_level_index=1,
    )
    return Accelerator(
        name="PE64x64", cores=(core,),
        interconnect_bandwidth=64.0,
        offchip_bandwidth=64.0,
        frequency_hz=1e9,
    )


def multi_core_array(n_cores: int, l1_io_words: int = 1 << 22) -> Accelerator:
    """Sec. IV.C.3 multi-core variant: each core executes another attention
    head in parallel ('no inputs or weights are typically shared among
    heads')."""
    base = pe_array_64x64(l1_io_words).cores[0]
    cores = tuple(
        dataclasses.replace(base, name=f"pe64x64-{i}") for i in range(n_cores)
    )
    return Accelerator(
        name=f"PE64x64x{n_cores}", cores=cores,
        interconnect_bandwidth=64.0, offchip_bandwidth=64.0,
        frequency_hz=1e9,
        # dedicated 64-word links per ordered core pair; moving a word
        # core-to-core costs about an L2 access
        interconnect=Interconnect(bandwidth=64.0, energy_per_word=2.0,
                                  latency=0.0, topology="ptp"),
    )


def _core_kind(core: Core) -> tuple:
    """Structural signature of a core's compute resources: two cores
    with the same kind are interchangeable for placement purposes."""
    return (core.array_rows, core.array_cols, core.macs_per_pe_per_cycle,
            core.utilization,
            core.simd.width if core.simd is not None else None)


def is_heterogeneous(accel: Accelerator) -> bool:
    """True when the platform mixes core types (different array shapes
    or SIMD widths) — the regime where placement must be type-aware."""
    return len({_core_kind(c) for c in accel.cores}) > 1


def widest_simd_core(accel: Accelerator) -> Optional[int]:
    """Index of the core with the widest SIMD unit (softmax target), or
    None when no core can execute vector nodes at all."""
    best = None
    for i, c in enumerate(accel.cores):
        if c.simd is None:
            continue
        if best is None or c.simd.width > accel.cores[best].simd.width:
            best = i
    return best


def widest_array_core(accel: Accelerator) -> int:
    """Index of the core with the highest sustained MAC throughput (the
    big-matmul target)."""
    return max(range(len(accel.cores)),
               key=lambda i: accel.cores[i].effective_macs_per_cycle)


def pe_array_core(name: str = "pe64x64", *, simd_width: int = 2,
                  l1_io_words: int = 1 << 22) -> Core:
    """A matmul-oriented 64x64 PE-array core with a deliberately NARROW
    SIMD unit: vector nodes (softmax, layernorm, accumulation) are
    *legal* on it but slow — the cost gradient the heterogeneous GA
    exploits when a SIMD-heavy core exists next door."""
    levels = (
        MemoryLevel("L1-io", size=l1_io_words, bandwidth=64.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L1-rhs", size=l1_io_words, bandwidth=4096.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L2", size=None, bandwidth=64.0,
                    read_energy=8.0, write_energy=9.0),
    )
    return Core(name=name, array_rows=64, array_cols=64, mac_energy=1.0,
                utilization=1.0, levels=levels,
                simd=SIMDUnit(width=simd_width, op_energy=0.2),
                rhs_level_index=1)


def simd_heavy_core(name: str = "simd2048", *, simd_width: int = 2048,
                    l1_io_words: int = 1 << 22) -> Core:
    """A vector-oriented core: a small 8x8 array beside a very wide
    SIMD unit — softmax-heavy stages migrate here."""
    levels = (
        MemoryLevel("L1-io", size=l1_io_words, bandwidth=64.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L2", size=None, bandwidth=64.0,
                    read_energy=8.0, write_energy=9.0),
    )
    return Core(name=name, array_rows=8, array_cols=8, mac_energy=0.6,
                utilization=1.0, levels=levels,
                simd=SIMDUnit(width=simd_width, op_energy=0.1))


def mxu_core(name: str = "mxu128", *, l1_io_words: int = 1 << 22) -> Core:
    """An MXU-like core: a wide 128x128 systolic array with NO SIMD
    unit at all — vector nodes raise ``IllegalSchedule`` on it, so
    searches over platforms containing one must tolerate infeasible
    genomes (core/allocation.py scores them +inf)."""
    levels = (
        MemoryLevel("L1-io", size=l1_io_words, bandwidth=128.0,
                    read_energy=1.0, write_energy=1.2),
        MemoryLevel("L2", size=None, bandwidth=64.0,
                    read_energy=8.0, write_energy=9.0),
    )
    return Core(name=name, array_rows=128, array_cols=128, mac_energy=0.8,
                utilization=1.0, levels=levels, simd=None)


def hetero_platform(n_pe: int = 1, n_simd: int = 1, n_mxu: int = 0, *,
                    pe_simd_width: int = 2, simd_width: int = 2048,
                    l1_io_words: int = 1 << 22) -> Accelerator:
    """A heterogeneous multi-core platform mixing the three core types
    this repo's DSE distinguishes: ``n_pe`` 64x64 PE-array cores
    (narrow SIMD), ``n_simd`` SIMD-heavy cores, and ``n_mxu`` MXU-like
    cores (no SIMD).  Cores are ordered PE, SIMD, MXU; the same
    point-to-point fabric as ``multi_core_array``."""
    cores = tuple(
        pe_array_core(f"pe64x64-{i}", simd_width=pe_simd_width,
                      l1_io_words=l1_io_words) for i in range(n_pe)
    ) + tuple(
        simd_heavy_core(f"simd-{i}", simd_width=simd_width,
                        l1_io_words=l1_io_words) for i in range(n_simd)
    ) + tuple(
        mxu_core(f"mxu-{i}", l1_io_words=l1_io_words)
        for i in range(n_mxu)
    )
    return Accelerator(
        name=f"hetero[{n_pe}pe+{n_simd}simd+{n_mxu}mxu]", cores=cores,
        interconnect_bandwidth=64.0, offchip_bandwidth=64.0,
        frequency_hz=1e9,
        interconnect=Interconnect(bandwidth=64.0, energy_per_word=2.0,
                                  latency=0.0, topology="ptp"),
    )


def tpu_v5e_like() -> Accelerator:
    """The JAX package's TPU co-design platform, a DSE input only (not
    the H100): 197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI.

    MXU modelled as a 128x128 array at 940 MHz-equivalent issue
    (197e12 / 2 FLOP-per-MAC / 128^2 ~= 6.0 GHz-MAC; we normalise the
    frequency instead), VMEM ~128 MiB, HBM 16 GiB.
    """
    word = 2  # bf16 bytes
    freq = 940e6 * 6.4  # normalised so peak_macs*freq == 98.5e12 MAC/s
    levels = (
        MemoryLevel("VMEM", size=(128 << 20) // word, bandwidth=512.0,
                    read_energy=1.0, write_energy=1.0),
        MemoryLevel("HBM", size=(16 << 30) // word,
                    bandwidth=819e9 / word / freq,
                    read_energy=80.0, write_energy=80.0),
    )
    core = Core(
        name="tpu-v5e-chip",
        array_rows=128, array_cols=128,
        mac_energy=0.4, utilization=1.0,
        levels=levels,
        simd=SIMDUnit(width=8 * 128, op_energy=0.1),
    )
    return Accelerator(
        name="TPUv5e", cores=(core,),
        interconnect_bandwidth=50e9 / word / freq,
        offchip_bandwidth=819e9 / word / freq,
        frequency_hz=freq,
        # ICI: ~50 GB/s/link point-to-point; DMA setup dominates small
        # transfers, energy per word far above on-chip SRAM
        interconnect=Interconnect(bandwidth=50e9 / word / freq,
                                  energy_per_word=40.0, latency=1e3,
                                  topology="ptp"),
    )
