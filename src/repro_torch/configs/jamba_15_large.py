"""jamba-1.5-large-398b [hybrid] -- 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave
(period 8, attention at offset 3), MoE every other layer.
[arXiv:2403.19887; hf]  The same dims as the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=65536,
    attn_every=8, attn_offset=3,
    moe=True, n_experts=16, top_k=2, d_expert=24576, moe_every=2,
    d_inner=16384, ssm_state=128, ssm_heads=256, ssm_head_dim=64,
    ssm_groups=8, conv_width=4,
    rope_theta=1e6, mlp="silu_glu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="jamba-1.5-smoke",
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=192, n_experts=4, d_expert=192, capacity_factor=4.0,
    d_inner=256, ssm_state=32, ssm_heads=8, ssm_head_dim=32,
    ssm_groups=2, vocab_size=256, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
