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
(jamba-1.5, whose FFNs alternate dense and Mixture-of-Experts).

``SHAPES`` are the JAX package's assigned input shapes, per LM arch:

    train_4k     seq 4096   global_batch 256   (train_step)
    prefill_32k  seq 32768  global_batch 32    (serve prefill)
    decode_32k   seq 32768  global_batch 128   (serve_step, 1 new token)
    long_500k    seq 524288 global_batch 1     (serve_step; sub-quadratic
                                                archs only)

hubert (encoder-only) has no decode/long shapes; long_500k runs only for
mamba2 (SSM) and jamba (hybrid).  ``input_specs`` gives each cell's
model inputs as ``meta`` tensors (shapes and dtypes, no storage), the
port's stand-in for JAX's ShapeDtypeStructs."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

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


SUBQUADRATIC = {"mamba2-130m", "jamba-1.5-large-398b"}
ENCODER_ONLY = {"hubert-xlarge"}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(arch: str, shape_name: str) -> tuple:
    """(runnable, reason if skipped) by the assignment's rules."""
    if arch in ENCODER_ONLY and shape_name in ("decode_32k", "long_500k"):
        return False, "encoder-only: no autoregressive decode"
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: long_500k needs " \
                      "sub-quadratic attention (assignment rule)"
    return True, ""


def cells(arch: Optional[str] = None) -> list:
    """Every (arch, shape, runnable, reason) assignment cell."""
    out = []
    for a in ([arch] if arch else list_archs()):
        for s in SHAPES:
            ok, why = applicable(a, s)
            out.append((a, s, ok, why))
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, cfg=None,
                shape: Optional[Shape] = None) -> dict:
    """One cell's model inputs as meta tensors: train -> {"batch":
    {tokens/embeds/targets}}, prefill -> {"tokens"} or {"embeds"},
    decode -> {"batch": B, "max_len": S}, the decode state's geometry.
    ``shape``: a geometry in place of the named shape's."""
    cfg = cfg or get_config(arch)
    sh = shape or SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
    emb_dt = cfg.torch_dtype()
    i32 = torch.int32
    if sh.kind == "train":
        if arch == "hubert-xlarge":
            batch = {"embeds": _meta((b, s, cfg.frontend_dim), emb_dt),
                     "targets": _meta((b, s), i32)}
        elif arch == "internvl2-2b":
            from repro_torch.configs.internvl2_2b import PATCH_TOKENS
            text = s - PATCH_TOKENS
            batch = {"embeds": _meta((b, PATCH_TOKENS, cfg.frontend_dim),
                                     emb_dt),
                     "tokens": _meta((b, text + 1), i32)}
        else:
            batch = {"tokens": _meta((b, s + 1), i32)}
        return {"batch": batch}
    if sh.kind == "prefill":
        if arch == "hubert-xlarge":
            return {"embeds": _meta((b, s, cfg.frontend_dim), emb_dt)}
        return {"tokens": _meta((b, s), i32)}
    return {"batch": b, "max_len": s}
