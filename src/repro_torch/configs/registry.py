"""Architecture registry: ``--arch <id>`` resolution for launchers/tests.

Only the architectures whose model code the PyTorch port already carries are
listed; asking for another id raises ``KeyError`` naming it as not yet ported.
"""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "list_archs"]

#: arch id -> module name
_MODULES: dict[str, str] = {
    "llama3.2-1b": "llama3_2_1b",
}

#: architectures the reference package serves that this port does not yet
_NOT_YET_PORTED = (
    "glm4-9b", "qwen3-14b", "minitron-8b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
    "recurrentgemma-9b", "rwkv6-1.6b", "seamless-m4t-large-v2", "internvl2-26b",
)

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        if arch in _NOT_YET_PORTED:
            raise KeyError(f"arch {arch!r} is not yet ported; ported: {sorted(_MODULES)}")
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)
