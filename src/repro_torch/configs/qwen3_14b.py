"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]  The same dims as
the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, mlp="silu_glu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen3-14b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=256, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
