"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504; encoder-only (no causal mask, no decode shapes).  The
convolutional waveform frontend is a stub: the model takes precomputed
frame embeddings (B, S, 1280) through ``frontend_proj``.
[arXiv:2106.07447]  The same dims as the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    # published label space 504, padded to 512 for TP logit sharding
    d_ff=5120, vocab_size=512,
    causal=False, mlp="gelu",
    frontend="audio_stub", frontend_dim=1280,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="hubert-xlarge-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
    d_ff=256, vocab_size=64, frontend_dim=96, param_dtype="float32",
    compute_dtype="float32", remat="none", attn_impl="xla")
