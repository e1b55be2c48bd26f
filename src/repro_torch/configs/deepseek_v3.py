"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (expert)
vocab=129280, MoE 256 routed top-8 + 1 shared, MLA (q_lora 1536,
kv_lora 512, rope 64, nope 128, v 128), first 3 layers dense
(d_ff 18432).  MTP head not modelled (single-token loss).
[arXiv:2412.19437; hf]  The same dims as the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=192,
    d_ff=18432, vocab_size=129280,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    moe=True, n_experts=256, top_k=8, d_expert=2048,
    n_shared_experts=1, first_dense_layers=3,
    rope_theta=1e4, mlp="silu_glu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="deepseek-v3-smoke",
    n_layers=3, first_dense_layers=1, d_model=128, n_heads=4,
    n_kv_heads=4, d_head=48,
    q_lora_rank=64, kv_lora_rank=48, qk_rope_head_dim=16,
    qk_nope_head_dim=32, v_head_dim=32,
    d_ff=256, n_experts=8, top_k=2, d_expert=96, vocab_size=256,
    capacity_factor=4.0, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
