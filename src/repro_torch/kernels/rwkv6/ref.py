"""Sequential oracle for the RWKV-6 WKV recurrence.

Per head, with state ``S ∈ R^{K×V}``, data-dependent per-channel decay
``w_t ∈ (0,1)^K`` and bonus ``u ∈ R^K`` (Finch, arXiv:2404.05892):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Shapes: r/k/w (B,S,H,K); v (B,S,H,V); u (H,K); state (B,H,K,V).
"""

from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,V) in r's dtype, final state (B,H,K,V) f32)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, :, None]
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    S = state.float()
    ys = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((b, 0, h, dv))
    return y.to(r.dtype), S
