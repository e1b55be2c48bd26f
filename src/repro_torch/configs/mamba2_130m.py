"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]  The same
dims as the JAX package's config."""

import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24, d_model=768, n_heads=0, attn_every=0,
    # published vocab 50280, padded to 50304 (a multiple of 256), as the
    # JAX package pads it; pad ids are never targeted
    d_ff=0, vocab_size=50304,
    d_inner=1536, ssm_state=128, ssm_heads=24, ssm_head_dim=64,
    ssm_groups=1, conv_width=4,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="mamba2-130m-smoke",
    n_layers=2, d_model=128, d_inner=256, ssm_state=32, ssm_heads=4,
    ssm_head_dim=64, vocab_size=256, param_dtype="float32",
    compute_dtype="float32", remat="none")
