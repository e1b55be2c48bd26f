"""The port's copy of the JAX package's DSE core (``repro/core``): the
Stream-class analytical engine extended with transformer layer types
and layer-fused scheduling, and the phase-aware schedule selector that
the lowering layer turns into serving plans.

Every module is pure Python, copied with its names and arithmetic so
that results are bit-equal to the reference's, and imported from here
without JAX.  ``codesign`` is the card's counterpart: its tiles are the
CUDA kernels' own.  ``allocation`` is the heterogeneous genetic
allocator (Stream's step 4: attention heads to cores, and on a
heterogeneous platform each head's softmax core); it is analytical
only, and nothing on the card calls it.

Units across the API: latency in cycles (Mcycles = 1e6 in reprs),
energy in pJ, memory in words (2 bytes/word).
"""
from repro_torch.core import (allocation, analytical, codesign, costmodel,
                              engine, interconnect, spacegen)
from repro_torch.core.accelerator import (Accelerator, Core, MemoryLevel,
                                          SIMDUnit, gap8, multi_core_array,
                                          pe_array_64x64, tpu_v5e_like)
from repro_torch.core.allocation import (GAResult, heads_schedule,
                                         optimize_allocation)
from repro_torch.core.costmodel import AnalyticalCostModel, CostModel
from repro_torch.core.dependencies import ALL, Requirement, required_inputs
from repro_torch.core.fusion import (PhasePlan, best_schedule, explore,
                                     fuse_all, fuse_pv, fuse_q_qkt, lbl,
                                     multi_head_candidates, phase_policy,
                                     phase_schedule, select_schedule)
from repro_torch.core.interconnect import Interconnect, LinkTimeline, Transfer
from repro_torch.core.nodes import (ComputationNode, split_layer,
                                    split_workload)
from repro_torch.core.scheduler import (WORD_BYTES, IllegalSchedule, Result,
                                        Schedule, Stage, evaluate,
                                        layer_by_layer)
from repro_torch.core.spacegen import (SpaceOptions, block_subworkload,
                                       chain_schedule, generate)
from repro_torch.core.validation import (validate, validate_all,
                                         validate_schedule)
from repro_torch.core.workload import (INPUT, KVCACHE, PHASES, WEIGHT,
                                       Elementwise, Layer, LayerNorm, MatMul,
                                       Softmax, Transpose, Workload,
                                       attention_head, cct_mhsa, ffn,
                                       from_model_config, gqa_attention,
                                       kv_cached_attention, mhsa, network,
                                       parallel_heads, transformer_block)

__all__ = [
    "allocation", "analytical", "codesign", "costmodel", "engine",
    "interconnect", "spacegen",
    "Accelerator", "Core", "MemoryLevel", "SIMDUnit",
    "gap8", "multi_core_array", "pe_array_64x64", "tpu_v5e_like",
    "GAResult", "heads_schedule", "optimize_allocation",
    "AnalyticalCostModel", "CostModel",
    "ALL", "Requirement", "required_inputs",
    "PhasePlan", "best_schedule", "explore", "fuse_all", "fuse_pv",
    "fuse_q_qkt", "lbl", "multi_head_candidates", "phase_policy",
    "phase_schedule", "select_schedule",
    "Interconnect", "LinkTimeline", "Transfer",
    "ComputationNode", "split_layer", "split_workload",
    "WORD_BYTES", "IllegalSchedule", "Result", "Schedule", "Stage",
    "evaluate", "layer_by_layer",
    "SpaceOptions", "block_subworkload", "chain_schedule", "generate",
    "validate", "validate_all", "validate_schedule",
    "INPUT", "KVCACHE", "PHASES", "WEIGHT", "Elementwise", "Layer",
    "LayerNorm", "MatMul", "Softmax", "Transpose", "Workload",
    "attention_head", "cct_mhsa", "ffn", "from_model_config",
    "gqa_attention", "kv_cached_attention", "mhsa", "network",
    "parallel_heads", "transformer_block",
]
