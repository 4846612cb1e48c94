"""Convert parameter and cache trees between numpy (the reference package's
arrays, as ``np.asarray(leaf)``) and the port's tensors.

Trees are nested dicts/tuples/lists with ``None`` holes, as both packages
build them.  ``torch.from_numpy`` rejects the ``ml_dtypes`` bfloat16 arrays
that bf16 leaves come out as, so bf16 crosses through a ``uint16`` bit view in
both directions: the conversion is bit-exact.  This module imports no JAX;
callers hand it numpy leaves.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.layers import tree_map

__all__ = ["to_torch", "to_numpy"]


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_torch(tree: Any, device: str | torch.device = "cpu") -> Any:
    """numpy-leaf tree -> tensor tree on ``device`` (bf16 bit-exact)."""

    def convert(leaf) -> torch.Tensor:
        a = np.array(leaf, copy=True)  # writable, contiguous, owned by the tensor
        if _is_bf16(a):
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return tree_map(convert, tree)


def to_numpy(tree: Any) -> Any:
    """tensor tree -> numpy-leaf tree on the host (bf16 as ``ml_dtypes``
    bfloat16, bit-exact)."""

    def convert(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # only the bf16 direction back needs it

            return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
        return t.numpy()

    return tree_map(convert, tree)
