"""Per-kind layer blocks — the dense ``"attn"`` block of the PyTorch port.

The block exposes three pieces:
  * ``block_specs(cfg, kind, stack)``        — PSpec tree for one layer,
  * ``block_cache_specs(cfg, kind, B, Smax)`` — PSpec tree for its decode cache,
  * ``block_apply(cfg, kind, p, h, ...)``     — forward in one of three modes:
      "train"   : full sequence, no cache,
      "prefill" : full sequence, fills the cache,
      "decode"  : one token against the cache (S == 1).

Global attention keeps (B, Smax, KV, hd) K/V written at absolute positions.
Unlike the reference, whose arrays are immutable, prefill and decode write
K/V into the cache tensors they are given, in place (no copy of the cache per
step), and return that same cache.

The other block kinds of the reference (``attn_local``, ``xattn``, ``rglru``,
``rwkv``) and MoE feed-forwards raise ``NotImplementedError`` naming the
ROADMAP item that will port them.
"""

from __future__ import annotations

from typing import Any

import torch

from ..kernels.rmsnorm.ops import rms_norm_fused
from .attention import attention, decode_attention
from .config import ArchConfig
from .layers import PSpec, apply_rotary, gated_mlp, gated_mlp_specs, rms_norm, rotary_embedding

__all__ = ["block_specs", "block_cache_specs", "block_apply", "norm"]

#: block kind -> the ROADMAP Queue 1 item that ports it
_NOT_YET_PORTED = {
    "attn_local": "hybrid family (recurrentgemma-9b)",
    "rglru": "hybrid family (recurrentgemma-9b)",
    "rwkv": "SSM family (rwkv6-1.6b)",
    "xattn": "MoE, encdec, vlm",
}


def _unported(kind: str) -> NotImplementedError:
    if kind in _NOT_YET_PORTED:
        return NotImplementedError(
            f"block kind {kind!r} is not yet ported (ROADMAP Queue 1: {_NOT_YET_PORTED[kind]})"
        )
    return NotImplementedError(f"unknown block kind {kind!r}")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def norm(cfg: ArchConfig, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Config-dispatched rmsnorm: the unfused reference or the hand-written
    fused kernel (``cfg.norm_impl == "fused"``; its plain version on CPU
    tensors).  Both compute in f32 and return ``x.dtype``."""
    if cfg.norm_impl == "fused":
        return rms_norm_fused(x, weight, cfg.norm_eps)
    return rms_norm(x, weight, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ArchConfig, stack: tuple[int, ...]) -> dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = _dtype(cfg)
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    specs: dict[str, Any] = {
        "ln": PSpec(lead + (d,), lax_ + (None,), init="ones", dtype=dt),
        "wq": PSpec(lead + (d, cfg.q_dim), lax_ + ("embed", "heads"), dtype=dt),
        "wk": PSpec(lead + (d, cfg.kv_dim), lax_ + ("embed", "kv_heads"), dtype=dt),
        "wv": PSpec(lead + (d, cfg.kv_dim), lax_ + ("embed", "kv_heads"), dtype=dt),
        "wo": PSpec(lead + (cfg.q_dim, d), lax_ + ("heads", "embed"), dtype=dt),
    }
    if cfg.use_qk_norm:
        specs["qn"] = PSpec(lead + (hd,), lax_ + (None,), init="ones", dtype=dt)
        specs["kn"] = PSpec(lead + (hd,), lax_ + (None,), init="ones", dtype=dt)
    return specs


def _ffn_specs(cfg: ArchConfig, stack: tuple[int, ...]) -> dict[str, Any]:
    if cfg.moe is not None:
        raise NotImplementedError("MoE feed-forward is not yet ported (ROADMAP Queue 1: MoE, encdec, vlm)")
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    dt = _dtype(cfg)
    return {
        "ln2": PSpec(lead + (cfg.d_model,), lax_ + (None,), init="ones", dtype=dt),
        "mlp": gated_mlp_specs(cfg.d_model, cfg.d_ff, dt, stack),
    }


def block_specs(cfg: ArchConfig, kind: str, stack: tuple[int, ...] = ()) -> dict[str, Any]:
    if kind != "attn":
        raise _unported(kind)
    specs = _attn_specs(cfg, stack)
    specs.update(_ffn_specs(cfg, stack))
    return specs


def block_cache_specs(
    cfg: ArchConfig, kind: str, batch: int, max_seq: int, stack: tuple[int, ...] = ()
) -> dict[str, Any]:
    if kind != "attn":
        raise _unported(kind)
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    dt = _dtype(cfg)
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    kvshape = lead + (batch, max_seq, kv, hd)
    kvaxes = lax_ + ("batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
        "v": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
    }


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = norm(cfg, q, p["qn"])
        k = norm(cfg, k, p["kn"])
    return q, k, v


def _attn_core_train(cfg, p, h, rope, *, mode, cache):
    """Causal self-attention over a full sequence (train or prefill)."""
    x = norm(cfg, h, p["ln"])
    q, k, v = _project_qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    att = attention(q, k, v, impl=cfg.attn_impl, causal=True, chunk=cfg.attn_chunk)
    out = att.reshape(att.shape[0], att.shape[1], -1) @ p["wo"]
    h = h + out
    new_cache = None
    if mode == "prefill":
        if cache is None:
            new_cache = {"k": k, "v": v}
        else:
            s = k.shape[1]
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            new_cache = cache
    return h, new_cache


def _attn_core_decode(cfg, p, h, cache, pos):
    """One-token self-attention against the cache. h: (B,1,D); pos: (B,)."""
    x = norm(cfg, h, p["ln"])
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rotary_embedding(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    b = q.shape[0]
    rows = torch.arange(b, device=pos.device)
    col = pos.long()
    cache["k"][rows, col] = k[:, 0]
    cache["v"][rows, col] = v[:, 0]
    t = cache["k"].shape[1]
    valid = torch.arange(t, device=pos.device)[None, :] <= col[:, None]
    att = decode_attention(q, cache["k"], cache["v"], valid)
    out = att.reshape(b, 1, -1) @ p["wo"]
    return h + out, cache


def _ffn_apply(cfg, p, h):
    x = norm(cfg, h, p["ln2"])
    return h + gated_mlp(p["mlp"], x)


def block_apply(
    cfg: ArchConfig,
    kind: str,
    p: dict[str, Any],
    h: torch.Tensor,
    *,
    rope=None,
    mode: str = "train",
    cache: dict[str, Any] | None = None,
    pos: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, Any] | None]:
    """Apply one block. Returns (h, new_cache); dense blocks carry no aux loss."""
    if kind != "attn":
        raise _unported(kind)
    if mode == "decode":
        h, new_attn = _attn_core_decode(cfg, p, h, cache, pos)
    else:
        h, new_attn = _attn_core_train(cfg, p, h, rope, mode=mode, cache=cache)
    return _ffn_apply(cfg, p, h), new_attn
