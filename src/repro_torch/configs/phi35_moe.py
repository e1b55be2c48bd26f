"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]  The same dims as the JAX
package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab_size=32064,
    moe=True, n_experts=16, top_k=2, d_expert=6400,
    rope_theta=1e4, mlp="silu_glu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="phi3.5-moe-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=192, vocab_size=256, n_experts=4, d_expert=192,
    capacity_factor=4.0, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
