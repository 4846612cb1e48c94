"""Attention: GQA with causal / sliding-window masks, three implementations.

* ``naive``   — full (S×T) score matrix; the oracle (also ``kernels/flash_attention/ref.py``).
* ``chunked`` — memory-efficient exact attention: a loop over query chunks;
  each chunk computes an exact softmax against (a band of) K/V, so the S×T
  buffer never materializes.  For sliding-window attention only the K/V band
  covering the window is sliced per chunk.
* ``pallas``  — the name the reference gives its flash kernel; here it selects
  the hand-written CUDA flash kernel (kernels/flash_attention), which runs on
  CUDA tensors and takes its plain PyTorch version on CPU tensors.

Shapes: q (B, S, H, hd); k/v (B, T, KV, hd); GQA group = H // KV.
"""

from __future__ import annotations

import torch

__all__ = ["attention", "decode_attention", "naive_attention", "chunked_attention"]

_NEG_INF = -2.0e38


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, kv, g, hd = x.shape
    return x.reshape(b, s, kv * g, hd)


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int | None
) -> torch.Tensor:
    """(Sq, Tk) additive bias from position arrays."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, _NEG_INF)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-matrix reference attention.  ``q_offset`` is the position of the
    first query in the causal and window masks."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qg = _split_heads(q, n_kv)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(s, device=q.device)
    k_pos = torch.arange(t, device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return _merge_heads(out)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Exact attention, looped over query chunks (no S×T buffer)."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if s % chunk != 0 or s <= chunk:
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    n_chunks = s // chunk
    scale = hd ** -0.5
    qg = _split_heads(q, n_kv).reshape(b, n_chunks, chunk, n_kv, h // n_kv, hd)

    # For sliding-window attention only a band of K/V is needed per q chunk.
    band = None
    if window is not None:
        band = min(t, ((window + chunk + 127) // 128) * 128)

    outs = []
    for idx in range(n_chunks):
        q_pos = q_offset + idx * chunk + torch.arange(chunk, device=q.device)
        if band is not None and band < t:
            start = min(max(idx * chunk - (band - chunk), 0), t - band)
            kc, vc = k[:, start : start + band], v[:, start : start + band]
            k_pos = start + torch.arange(band, device=q.device)
        else:
            kc, vc = k, v
            k_pos = torch.arange(t, device=q.device)
        scores = torch.einsum("bckgd,btkd->bkgct", qg[:, idx].float(), kc.float()) * scale
        scores = scores + _mask_bias(q_pos, k_pos, causal, window)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgct,btkd->bckgd", probs.to(vc.dtype), vc))
    out = torch.stack(outs, dim=1).reshape(b, s, n_kv, h // n_kv, hd)
    return _merge_heads(out)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "chunked",
    causal: bool = True,
    window: int | None = None,
    chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(
            q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset
        )
    if impl == "pallas":  # the kernel's masks start at 0; the reference's drops q_offset too
        from ..kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,
) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, T, KV, hd); kv_valid: (B, T) bool.
    """
    b, _, h, hd = q.shape
    n_kv = k_cache.shape[2]
    scale = hd ** -0.5
    qg = _split_heads(q, n_kv)[:, 0]  # (B, KV, G, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    scores = scores.masked_fill(~kv_valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)
