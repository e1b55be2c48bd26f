"""The architectures the port runs so far, with the JAX package's
dims: ``get_config(arch, smoke=...)`` returns the full published config
or its reduced same-family smoke twin.  ``list_archs("dense")`` names
the dense GQA stacks (the decoders, the hubert-xlarge encoder and the
internvl2-2b VLM backbone, whose stub frontends feed ``frontend_proj``),
``list_archs("moe")`` the GQA stacks whose FFN is a Mixture-of-Experts
(phi3.5-moe), ``list_archs("mla")`` the Multi-head Latent Attention
stacks (deepseek-v3, whose FFNs are a dense prefix and then
Mixture-of-Experts), ``list_archs("ssm")`` the attention-free Mamba-2
stacks, ``list_archs("hybrid")`` the attention/Mamba-2 interleaves
(jamba-1.5, whose FFNs alternate dense and Mixture-of-Experts)."""

from __future__ import annotations

import importlib
from typing import Optional

ARCHS = {
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large",
}


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(ARCHS[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def family(arch: str) -> str:
    """``"ssm"`` for an attention-free stack, ``"hybrid"`` for one
    that interleaves attention and Mamba-2 layers (whatever its FFNs),
    ``"mla"`` for one with Multi-head Latent Attention, ``"moe"`` for a
    GQA stack with Mixture-of-Experts FFNs, else ``"dense"``."""
    cfg = get_config(arch)
    if cfg.attn_every == 0:
        return "ssm"
    if cfg.attn_every > 1:
        return "hybrid"
    if cfg.attention == "mla":
        return "mla"
    return "moe" if cfg.moe else "dense"


def list_archs(family_: Optional[str] = None) -> list:
    """Every arch, or those of one family (``"dense"``, ``"moe"``,
    ``"mla"``, ``"ssm"`` or ``"hybrid"``)."""
    return [a for a in ARCHS if family_ is None or family(a) == family_]
