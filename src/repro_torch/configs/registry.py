"""Architecture registry: ``--arch <id>`` resolution for launchers/tests.

Every architecture of the reference package resolves here, each from the
port's own copy of its config module; an unknown id raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "list_archs"]

#: arch id -> module name
_MODULES: dict[str, str] = {
    "glm4-9b": "glm4_9b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-14b": "qwen3_14b",
    "minitron-8b": "minitron_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)
