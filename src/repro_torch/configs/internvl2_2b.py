"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 (InternLM2-1.8B language backbone).  The InternViT vision
frontend is a stub: the model takes 256 precomputed patch embeddings
(B, 256, 1024) through ``frontend_proj``, placed before the text.
[arXiv:2404.16821; hf]  The same dims as the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    # published vocab 92553, padded to 92672 (multiple of 256) for TP
    # logit sharding (pad ids never targeted)
    d_ff=8192, vocab_size=92672,
    frontend="vision_stub", frontend_dim=1024,
    rope_theta=1e6, mlp="silu_glu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

#: patch embeddings per image, placed before the text
PATCH_TOKENS = 256

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="internvl2-2b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=256, frontend_dim=96, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
