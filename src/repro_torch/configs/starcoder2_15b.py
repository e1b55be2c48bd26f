"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA, RoPE.  [arXiv:2402.19173; hf]  The same dims as
the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
    d_ff=24576, vocab_size=49152,
    rope_theta=1e5, mlp="gelu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="starcoder2-15b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=256, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
