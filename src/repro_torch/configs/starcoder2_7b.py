"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152; GQA, RoPE.  [arXiv:2402.19173; hf]  The same dims as the
JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab_size=49152,
    rope_theta=1e5, mlp="gelu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="starcoder2-7b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=256, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
