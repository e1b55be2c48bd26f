"""Hardware/mapping co-design bridge for the H100: the tiles a lowered
plan records are the ones the port's CUDA kernel for its path launches.

The JAX package's ``repro/core/codesign.py`` picks (block_q, block_kv)
for its Pallas kernels against the TPU's VMEM and 128-wide MXU.  On the
card the analogue of the paper's L1 active-feature memory is the shared
memory of one thread block, and the kernels fix their own tiles at
compile time (``kernels/fused_attention.py`` ``MMA_ROWS``/``ROWS``/
``TILE``, ``kernels/fused_decode_block.py`` ``ROW_TILE``/``KEY_TILE``).
So :func:`plan_tiling` reads those constants instead of searching, and
checks the fused working set against the card's shared memory per
block.  The HBM-traffic expressions are the JAX package's, unchanged.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel

#: dynamic shared memory one block may opt into on the H100 (227 KiB;
#: ``kernels/ssd_scan.py`` ``SMEM_LIMIT``)
SMEM_PER_BLOCK_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class AttentionTiling:
    block_q: int                # query rows per thread block
    block_kv: int               # keys per K/V tile
    working_set_bytes: int
    smem_budget_bytes: int

    @property
    def fits(self) -> bool:
        return self.working_set_bytes <= self.smem_budget_bytes


def fused_attention_working_set(block_q: int, block_kv: int, d_head: int,
                                dtype_bytes: int = 2,
                                acc_bytes: int = 4) -> int:
    """Bytes held live by one step of the fused (Fig. 5c-style) kernel:
    Q tile + double-buffered K/V tiles + score tile + fp32 output
    accumulator + softmax stats (the JAX package's formula; on the card
    the last three sit in registers, so this bounds shared memory from
    above)."""
    q = block_q * d_head * dtype_bytes
    kv = 2 * (2 * block_kv * d_head * dtype_bytes)   # K,V double-buffered
    scores = block_q * block_kv * acc_bytes
    out = block_q * d_head * acc_bytes
    stats = 2 * block_q * acc_bytes
    return q + kv + scores + out + stats


def kernel_tiles(path: str, dtype_bytes: int = 2) -> tuple[int, int]:
    """(query rows per block, keys per tile) of the CUDA body the port
    launches for ``path`` in a ``dtype_bytes`` dtype: the decode
    megakernel's attention items, or the masked body's one-pass tiles
    (the tensor-core body in bf16, the FMA body in fp32).  The unfused
    path launches no attention kernel; it records the masked body's
    tiles, the rung its ladder steps up to."""
    # deferred: the kernel modules import torch, the DSE core does not
    from repro_torch.kernels import fused_attention as fa
    from repro_torch.kernels import fused_decode_block as fdb
    if path == "decode_megakernel":
        return fdb.ROW_TILE, fdb.KEY_TILE
    return (fa.MMA_ROWS if dtype_bytes == 2 else fa.ROWS), fa.TILE


def plan_tiling(phase: str, M: int, score_cols: int, d_head: int, *,
                path: str = "fused_attention", dtype_bytes: int = 2,
                smem_budget_bytes: int = SMEM_PER_BLOCK_BYTES,
                ) -> AttentionTiling:
    """Plan-resolved tiling for the lowering layer: one record per
    ``(phase, M, C, N, path)``.  The tiles are the kernel's own
    (:func:`kernel_tiles`); the working set is the fused model's at
    those tiles and the head width."""
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown phase {phase!r}")
    block_q, block_kv = kernel_tiles(path, dtype_bytes)
    ws = fused_attention_working_set(block_q, block_kv, d_head,
                                     dtype_bytes)
    return AttentionTiling(block_q, block_kv, ws, smem_budget_bytes)


def hbm_traffic_unfused(M: int, N: int, dtype_bytes: int = 2) -> int:
    """Bytes through HBM for the layer-by-layer score path: write+read of
    the M x M score matrix dominates (the paper's stored intermediate).
    Closed form lives in ``core/costmodel.py`` next to the node model."""
    return costmodel.attention_hbm_traffic(M, N, dtype_bytes, fused=False)


def hbm_traffic_fused(M: int, N: int, dtype_bytes: int = 2) -> int:
    """Fused (Fig. 5c analogue): score matrix never leaves on-chip
    memory."""
    return costmodel.attention_hbm_traffic(M, N, dtype_bytes, fused=True)


def fused_traffic_gain(M: int, N: int) -> float:
    """HBM-byte ratio fused/unfused, the paper's alpha re-expressed for
    off-chip traffic: -> 2/(M/N) for M >> N (score traffic dominates)."""
    return hbm_traffic_fused(M, N) / hbm_traffic_unfused(M, N)
