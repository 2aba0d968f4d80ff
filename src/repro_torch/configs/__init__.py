"""Architecture registry: one module per architecture (port of
``repro/configs``).

Each module exposes ``config()`` (the exact published configuration) and
``smoke()`` (a reduced same-family configuration for CPU smoke tests).
``get(name)`` / ``list_archs()`` are the public API; the launcher's
``--arch`` flag resolves through here.
"""
from __future__ import annotations

import importlib
from typing import List

_ARCHS = [
    "jamba_1_5_large_398b",
    "granite_8b",
    "starcoder2_15b",
    "gemma_7b",
    "starcoder2_3b",
    "deepseek_moe_16b",
    "dbrx_132b",
    "whisper_small",
    "rwkv6_7b",
    "phi_3_vision_4_2b",
]

ALIASES = {a.replace("_", "-"): a for a in _ARCHS}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(name: str):
    key = name.replace("-", "_").replace(".", "_")
    if key not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()
