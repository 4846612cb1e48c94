"""Sequential oracle for the RG-LRU diagonal gated linear recurrence
(RecurrentGemma / Griffin, arXiv:2402.19427):

    h_t = a_t ⊙ h_{t-1} + b_t,       a_t ∈ (0,1)^D

where the caller supplies ``a`` (data-dependent decay) and ``b`` (gated input,
already scaled by sqrt(1−a²)).  Sequential loop over time; f32 state.
"""

from __future__ import annotations

import torch

__all__ = ["linear_recurrence_ref"]


def linear_recurrence_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, D); h0: (B, D). Returns (h (B,S,D) in a's dtype, final (B,D) f32)."""
    bsz, s, d = a.shape
    af, bf = a.float(), b.float()
    h = torch.zeros((bsz, d), dtype=torch.float32, device=a.device) if h0 is None else h0.float()
    hs = []
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    y = torch.stack(hs, dim=1) if hs else af.new_zeros((bsz, 0, d))
    return y.to(a.dtype), h
