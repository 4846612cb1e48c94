
from .loader import DataLoader
from .synthetic import SyntheticConfig, SyntheticLM


__all__ = ["SyntheticConfig", "SyntheticLM", "DataLoader"]
