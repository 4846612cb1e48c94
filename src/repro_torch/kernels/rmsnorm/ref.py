"""Oracle for fused RMSNorm (same math as models.layers.rms_norm)."""

from __future__ import annotations

from ...models.layers import rms_norm as rms_norm_ref

__all__ = ["rms_norm_ref"]
