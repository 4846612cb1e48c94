from .registry import ARCH_IDS, get_config, get_smoke_config, list_archs

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "list_archs"]
