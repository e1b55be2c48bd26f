"""The architectures the port serves so far, with the JAX package's
dims: ``get_config(arch, smoke=...)`` returns the full published config
or its reduced same-family smoke twin."""

from __future__ import annotations

import importlib

ARCHS = {
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
}


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(ARCHS[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def list_archs() -> list:
    return list(ARCHS)
