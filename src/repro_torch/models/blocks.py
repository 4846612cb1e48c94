"""Per-kind layer blocks of the PyTorch port: attn / attn_local / xattn / rglru / rwkv.

Every block exposes three pieces:
  * ``block_specs(cfg, kind, stack)``        — PSpec tree for one layer,
  * ``block_cache_specs(cfg, kind, B, Smax)`` — PSpec tree for its decode cache,
  * ``block_apply(cfg, kind, p, h, ...)``     — forward in one of three modes:
      "train"   : full sequence, no cache,
      "prefill" : full sequence, fills the cache,
      "decode"  : one token against the cache (S == 1).

Cache design: global attention keeps (B, Smax, KV, hd) K/V written at
absolute positions; sliding-window attention keeps a ring buffer of
``window`` slots plus per-slot absolute positions (``slot_pos``, -1 when
empty); an enc-dec decoder block (``xattn``) keeps its self-attention's
K/V, the cross K/V over the encoder output (``xk``/``xv``, (B, Smax, KV,
hd), rows 0..T-1 filled at prefill) and each row's source length T
(``xlen``, int32 (B,): a leaf the reference lacks, whose cross K/V are T
long, so decode attends to exactly the T source positions); RG-LRU keeps
the (B, D) f32 recurrence state and the (B, cw-1, D) conv tail; RWKV keeps
the (B, H, K, V) f32 WKV state and the two token-shift vectors.  Unlike the
reference, whose arrays are immutable, prefill and decode write into the
cache tensors they are given, in place (no copy of the cache per step), and
return that same cache.

The recurrences of rglru and rwkv run as ``cfg.seq_impl`` says in train and
prefill ("parallel": the reference blocks' associative scan and chunked
WKV-6; "ref": sequential; "pallas": the CUDA kernels); decode takes one step
in plain PyTorch whatever it says, as the reference's blocks do.  All three
families train: dense and hybrid attention through the flash kernels'
backward (head_dim 16 to 256), the recurrences through ``"parallel"``,
whose PyTorch forms autograd differentiates as JAX differentiates the
reference's jnp forms; under ``"pallas"`` a loss's backward raises, since
the recurrence kernels have no backward (the reference has none either).

With ``cfg.moe`` the feed-forward of each attention block is the
mixture of experts of ``models/moe.py``; ``block_apply`` returns its
auxiliary (load-balancing) loss beside the hidden state, a zero f32 scalar
for every other block in training, as the reference's does.

Under a sharding context (``dist.context.use_sharding``) with DTensor
params and activations, the hand-written kernels still take plain tensors:
``norm`` and the attention call hand each kernel its rank's local shard
(``_local_norm``, ``_local_attention``: rows whole along the normalized
width; batch and heads kept sharded, the GQA group whole on every rank),
and wrap the result back into a DTensor.  The attention output is pinned to
``("batch", "seq", "heads", None)``, as the reference pins it.

The ``xattn`` block is self-attention (causal), cross-attention and the
feed-forward.  Its cross-attention takes q from the block's hidden state and
k/v from the encoder output, with no rotary embedding and no qk-norm, and is
not causal; the encoder's own blocks are ``attn`` blocks run with
``causal=False``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..dist.context import constrain, is_dtensor, local_apply, placements_of
from ..kernels.rglru import ops as rglru_ops
from ..kernels.rmsnorm.ops import rms_norm_fused
from ..kernels.rwkv6 import ops as rwkv_ops
from .attention import attention, decode_attention
from .config import ArchConfig
from .layers import PSpec, apply_rotary, gated_mlp, gated_mlp_specs, rms_norm, rotary_embedding
from .moe import moe_apply, moe_specs

__all__ = ["block_specs", "block_cache_specs", "block_apply", "norm"]

_RWKV_LORA = 64

#: cfg.seq_impl -> (rglru impl, rwkv impl) in train and prefill
_SEQ_IMPLS = {"parallel": ("assoc", "chunked"), "ref": ("ref", "ref"), "pallas": ("pallas", "pallas")}


def _seq_impls(cfg: ArchConfig) -> tuple[str, str]:
    if cfg.seq_impl not in _SEQ_IMPLS:
        raise ValueError(f"unknown seq_impl {cfg.seq_impl!r}; one of {sorted(_SEQ_IMPLS)}")
    return _SEQ_IMPLS[cfg.seq_impl]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def norm(cfg: ArchConfig, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Config-dispatched rmsnorm: the unfused reference or the hand-written
    fused kernel (``cfg.norm_impl == "fused"``; its plain version on CPU
    tensors).  Both compute in f32 and return ``x.dtype``.  A DTensor ``x``
    is normalized shard by shard (``_local_norm``)."""
    if is_dtensor(x):
        return _local_norm(cfg, x, weight)
    if cfg.norm_impl == "fused":
        return rms_norm_fused(x, weight, cfg.norm_eps)
    return rms_norm(x, weight, cfg.norm_eps)


def _local_norm(cfg: ArchConfig, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``norm`` of a DTensor on each rank's local rows: ``x`` keeps its
    shards except along the normalized width (gathered, a ``Partial``
    reduced), the weight is replicated (an FSDP-sharded one gathered), and
    the weight's gradient is each rank's part of the sum over the rows
    wherever ``x`` is sharded."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = placements_of(x, replicate_dims=(-1,))
    w_pl = (Replicate(),) * len(x_pl)
    w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x_pl)
    return local_apply(lambda xl, wl: norm(cfg, xl, wl), [(x, x_pl, None), (weight, w_pl, w_grad)],
                       [x_pl], mesh=x.device_mesh)


def _attend(cfg: ArchConfig, q, k, v, *, causal: bool, window: int | None):
    """``attention`` as ``cfg.attn_impl`` says; DTensors go through
    ``_local_attention``."""
    if is_dtensor(q):
        return _local_attention(cfg, q, k, v, causal=causal, window=window)
    return attention(q, k, v, impl=cfg.attn_impl, causal=causal, window=window,
                     chunk=cfg.attn_chunk)


def _local_attention(cfg: ArchConfig, q, k, v, *, causal: bool, window: int | None):
    """Attention of DTensors q (B,S,H,hd), k/v (B,T,KV,hd) on each rank's
    local shards: the batch stays sharded where q's is (k and v follow it),
    the heads where q's and k's are sharded on the same mesh axis (the port
    groups q heads contiguously per KV head, so a rank's q heads attend to
    its own KV heads); every other dimension, and a heads shard the two do
    not share, is gathered.  The output has q's placements."""
    from torch.distributed.tensor import Replicate, Shard

    q_pl = list(placements_of(q, replicate_dims=(1, 3)))
    k_pl = list(placements_of(k, replicate_dims=(1, 3)))
    for i, (qp, kp) in enumerate(zip(q_pl, k_pl)):
        if qp == Shard(0):
            k_pl[i] = qp
        elif not (qp == Shard(2) and kp == Shard(2)):
            q_pl[i] = k_pl[i] = Replicate()
    mesh = q.device_mesh
    sizes = dict(zip(range(mesh.ndim), mesh.shape))
    heads = q.shape[2] // math.prod(sizes[i] for i, p in enumerate(q_pl) if p == Shard(2))
    kv_heads = k.shape[2] // math.prod(sizes[i] for i, p in enumerate(k_pl) if p == Shard(2))
    if heads % kv_heads:
        raise ValueError(f"local heads {heads} are not a multiple of the local KV heads "
                         f"{kv_heads} (q {tuple(q.shape)} {q_pl}, k {tuple(k.shape)} {k_pl})")

    def run(ql, kl, vl):
        return attention(ql, kl, vl, impl=cfg.attn_impl, causal=causal, window=window,
                         chunk=cfg.attn_chunk)

    q_pl, k_pl = tuple(q_pl), tuple(k_pl)
    return local_apply(run, [(q, q_pl, None), (k, k_pl, None), (v, k_pl, None)], [q_pl],
                       mesh=mesh)


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
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    dt = _dtype(cfg)
    out: dict[str, Any] = {
        "ln2": PSpec(lead + (cfg.d_model,), lax_ + (None,), init="ones", dtype=dt)
    }
    if cfg.moe is not None:
        out["moe"] = moe_specs(cfg, stack)
    else:
        out["mlp"] = gated_mlp_specs(cfg.d_model, cfg.d_ff, dt, stack)
    return out


def _rglru_specs(cfg: ArchConfig, stack: tuple[int, ...]) -> dict[str, Any]:
    d = cfg.d_model
    dt = _dtype(cfg)
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    return {
        "ln": PSpec(lead + (d,), lax_ + (None,), init="ones", dtype=dt),
        "w_in": PSpec(lead + (d, d), lax_ + ("embed", "ffn"), dtype=dt),
        "w_gate": PSpec(lead + (d, d), lax_ + ("embed", "ffn"), dtype=dt),
        "conv": PSpec(lead + (cfg.conv_width, d), lax_ + ("conv", "ffn"), scale=0.5, dtype=dt),
        "rg_a": PSpec(lead + (d, d), lax_ + ("ffn", None), dtype=dt),
        "b_a": PSpec(lead + (d,), lax_ + (None,), init="zeros", dtype=dt),
        "rg_x": PSpec(lead + (d, d), lax_ + ("ffn", None), dtype=dt),
        "b_x": PSpec(lead + (d,), lax_ + (None,), init="zeros", dtype=dt),
        "lam": PSpec(lead + (d,), lax_ + (None,), init="ones", dtype=torch.float32),
        "w_out": PSpec(lead + (d, d), lax_ + ("ffn", "embed"), dtype=dt),
    }


def _rwkv_specs(cfg: ArchConfig, stack: tuple[int, ...]) -> dict[str, Any]:
    d, h, k = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_dim
    dt = _dtype(cfg)
    lead, lax_ = tuple(stack), ("layers",) * len(stack)

    def vec(init="normal"):
        return PSpec(lead + (d,), lax_ + (None,), init=init, scale=0.02, dtype=dt)

    return {
        "ln1": vec(init="ones"),
        "mu_r": vec(),
        "mu_k": vec(),
        "mu_v": vec(),
        "mu_w": vec(),
        "mu_g": vec(),
        "w_r": PSpec(lead + (d, d), lax_ + ("embed", "heads"), dtype=dt),
        "w_k": PSpec(lead + (d, d), lax_ + ("embed", "heads"), dtype=dt),
        "w_v": PSpec(lead + (d, d), lax_ + ("embed", "heads"), dtype=dt),
        "w_g": PSpec(lead + (d, d), lax_ + ("embed", "heads"), dtype=dt),
        "w_o": PSpec(lead + (d, d), lax_ + ("heads", "embed"), dtype=dt),
        "w0": PSpec(lead + (d,), lax_ + (None,), init="zeros", dtype=torch.float32),
        "w_lora_a": PSpec(lead + (d, _RWKV_LORA), lax_ + ("embed", None), dtype=dt),
        "w_lora_b": PSpec(lead + (_RWKV_LORA, d), lax_ + (None, "heads"), dtype=dt),
        "u": PSpec(lead + (h, k), lax_ + ("heads", None), scale=0.5, dtype=torch.float32),
        "gn": vec(init="ones"),
        "ln2": vec(init="ones"),
        "mu_ck": vec(),
        "mu_cr": vec(),
        "w_ck": PSpec(lead + (d, cfg.d_ff), lax_ + ("embed", "ffn"), dtype=dt),
        "w_cv": PSpec(lead + (cfg.d_ff, d), lax_ + ("ffn", "embed"), dtype=dt),
        "w_cr": PSpec(lead + (d, d), lax_ + ("embed", None), dtype=dt),
    }


def block_specs(cfg: ArchConfig, kind: str, stack: tuple[int, ...] = ()) -> dict[str, Any]:
    if kind in ("attn", "attn_local"):
        specs = _attn_specs(cfg, stack)
        specs.update(_ffn_specs(cfg, stack))
        return specs
    if kind == "xattn":  # decoder block: self-attn + cross-attn + ffn
        specs = {"self": _attn_specs(cfg, stack), "cross": _attn_specs(cfg, stack)}
        specs.update(_ffn_specs(cfg, stack))
        return specs
    if kind == "rglru":
        specs = {"rnn": _rglru_specs(cfg, stack)}
        specs.update(_ffn_specs(cfg, stack))
        return specs
    if kind == "rwkv":
        return _rwkv_specs(cfg, stack)
    raise ValueError(f"unknown block kind {kind!r}")


def block_cache_specs(
    cfg: ArchConfig, kind: str, batch: int, max_seq: int, stack: tuple[int, ...] = ()
) -> dict[str, Any]:
    d, hd, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_kv_heads
    dt = _dtype(cfg)
    lead, lax_ = tuple(stack), ("layers",) * len(stack)
    if kind == "attn":
        kvshape = lead + (batch, max_seq, kv, hd)
        kvaxes = lax_ + ("batch", "kv_seq", "kv_heads", "head_dim")
        return {
            "k": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
            "v": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
        }
    if kind == "attn_local":
        w = min(cfg.window or max_seq, max_seq)
        kvshape = lead + (batch, w, kv, hd)
        kvaxes = lax_ + ("batch", None, "kv_heads", "head_dim")
        return {
            "k": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
            "v": PSpec(kvshape, kvaxes, init="zeros", dtype=dt),
            "slot_pos": PSpec(lead + (batch, w), lax_ + ("batch", None), init="const",
                              const=-1, dtype=torch.int32),
        }
    if kind == "xattn":
        # cross K/V over the encoder output at max_seq, filled once at prefill
        cross = block_cache_specs(cfg, "attn", batch, max_seq, stack)
        return {
            "self": block_cache_specs(cfg, "attn", batch, max_seq, stack),
            "xk": cross["k"],
            "xv": cross["v"],
            "xlen": PSpec(lead + (batch,), lax_ + ("batch",), init="zeros", dtype=torch.int32),
        }
    if kind == "rglru":
        return {
            "h": PSpec(lead + (batch, d), lax_ + ("batch", "ffn"), init="zeros",
                       dtype=torch.float32),
            "conv": PSpec(lead + (batch, cfg.conv_width - 1, d), lax_ + ("batch", None, "ffn"),
                          init="zeros", dtype=dt),
        }
    if kind == "rwkv":
        h, k = cfg.rwkv_n_heads, cfg.rwkv_head_dim
        return {
            "wkv": PSpec(lead + (batch, h, k, k), lax_ + ("batch", "heads", None, None),
                         init="zeros", dtype=torch.float32),
            "shift_tm": PSpec(lead + (batch, d), lax_ + ("batch", None), init="zeros", dtype=dt),
            "shift_cm": PSpec(lead + (batch, d), lax_ + ("batch", None), init="zeros", dtype=dt),
        }
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Attention blocks
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


def _fill_ring(k, v, cache, window):
    """Prefill of a sliding-window cache: the last ``min(S, w)`` positions
    into their ring slots ``pos % w``, every other slot empty (-1).  Written
    into ``cache`` in place (it is reset first, as the reference builds a
    fresh ring), or into a new ring of ``min(window, S)`` slots."""
    b, s = k.shape[:2]
    if cache is None:
        w = min(window, s)
        cache = {
            "k": k.new_zeros((b, w) + k.shape[2:]),
            "v": v.new_zeros((b, w) + v.shape[2:]),
            "slot_pos": torch.full((b, w), -1, dtype=torch.int32, device=k.device),
        }
    else:
        w = cache["k"].shape[1]
        cache["k"].zero_()
        cache["v"].zero_()
        cache["slot_pos"].fill_(-1)
    w_fill = min(s, w)
    positions = torch.arange(s - w_fill, s, device=k.device)
    slots = positions % w
    cache["k"][:, slots] = k[:, s - w_fill:]
    cache["v"][:, slots] = v[:, s - w_fill:]
    cache["slot_pos"][:, slots] = positions.to(torch.int32)
    return cache


def _attn_core_train(cfg, p, h, rope, *, window, mode, cache, causal=True):
    """Self-attention over a full sequence (train or prefill); the encoder's
    is not causal."""
    x = norm(cfg, h, p["ln"])
    q, k, v = _project_qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    att = _attend(cfg, q, k, v, causal=causal, window=window)
    att = constrain(att, "batch", "seq", "heads", None)
    out = att.reshape(att.shape[0], att.shape[1], -1) @ p["wo"]
    h = h + out
    new_cache = None
    if mode == "prefill":
        if window is not None:
            new_cache = _fill_ring(k, v, cache, window)
        elif cache is None:
            new_cache = {"k": k, "v": v}
        else:
            s = k.shape[1]
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            new_cache = cache
    return h, new_cache


def _attn_core_decode(cfg, p, h, cache, pos, *, window):
    """One-token self-attention against the cache. h: (B,1,D); pos: (B,)."""
    x = norm(cfg, h, p["ln"])
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rotary_embedding(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    b = q.shape[0]
    rows = torch.arange(b, device=pos.device)
    col = pos.long()
    if window is None:
        t = cache["k"].shape[1]
        # a row past the cache's end (a free slot that decodes on) writes
        # nothing, as the reference's scatter drops out-of-range updates
        last = col.clamp_max(t - 1)
        inside = (col < t)[:, None, None]
        for name, new in (("k", k), ("v", v)):
            kept = cache[name][rows, last]
            cache[name][rows, last] = torch.where(inside, new[:, 0], kept)
        valid = torch.arange(t, device=pos.device)[None, :] <= col[:, None]
    else:
        slot = col % cache["k"].shape[1]
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        sp = cache["slot_pos"]
        sp[rows, slot] = pos.to(torch.int32)
        valid = (sp >= 0) & (sp > (col[:, None] - window)) & (sp <= col[:, None])
    att = decode_attention(q, cache["k"], cache["v"], valid)
    out = att.reshape(b, 1, -1) @ p["wo"]
    return h + out, cache


def _cross_attn(cfg, p, h, *, enc_out, mode, cache):
    """Cross-attention: q from ``h``, k/v from the encoder output, neither
    rotated nor qk-normed; not causal.  Prefill writes the cross K/V into
    rows 0..T-1 of ``xk``/``xv`` and T into ``xlen`` in place, or returns
    them as a fresh T-long cache when there is none; decode attends to the
    first ``xlen`` rows of each."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    x = norm(cfg, h, p["ln"])
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    fresh = None
    if mode == "decode":
        t = cache["xk"].shape[1]
        valid = torch.arange(t, device=h.device)[None, :] < cache["xlen"][:, None]
        att = decode_attention(q, cache["xk"], cache["xv"], valid)
    else:
        t = enc_out.shape[1]
        xk = (enc_out @ p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
        xv = (enc_out @ p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
        att = _attend(cfg, q, xk, xv, causal=False, window=None)
        if mode == "prefill" and cache is None:
            fresh = {"xk": xk, "xv": xv,
                     "xlen": torch.full((b,), t, dtype=torch.int32, device=h.device)}
        elif mode == "prefill":
            cache["xk"][:, :t] = xk
            cache["xv"][:, :t] = xv
            cache["xlen"].fill_(t)
    out = att.reshape(b, s, -1) @ p["wo"]
    return h + out, fresh


def _no_aux(h, mode):
    """The aux loss of a block without experts: an f32 zero in training;
    None in prefill and decode, which ignore it (a zero would cost a launch
    a layer in every decode step)."""
    return torch.zeros((), dtype=torch.float32, device=h.device) if mode == "train" else None


def _ffn_apply(cfg, p, h, mode):
    """(h + feed-forward, its aux loss)."""
    x = norm(cfg, h, p["ln2"])
    if cfg.moe is not None:
        y, aux = moe_apply(cfg, p["moe"], x)
        return h + y, aux
    return h + gated_mlp(p["mlp"], x), _no_aux(h, mode)


def _update(cache, fresh):
    """Write ``fresh`` into ``cache`` in place and return it, or return
    ``fresh`` itself when there is no cache."""
    if cache is None:
        return fresh
    for key, value in fresh.items():
        cache[key].copy_(value)
    return cache


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------

def _causal_conv(p_conv, x, state):
    """Depthwise causal conv, width cw. x: (B,S,D); state: (B,cw-1,D) or None."""
    cw = p_conv.shape[0]
    b, s, d = x.shape
    if state is None:
        state = x.new_zeros((b, cw - 1, d))
    xp = torch.cat([state, x], dim=1)  # (B, S+cw-1, D)
    y = sum(xp[:, j : j + s] * p_conv[j] for j in range(cw))
    return y, xp[:, s:]  # last cw-1 inputs


def _rglru_gates(cfg, p, u):
    """Decay a and driven input b of the recurrence, both f32."""
    uf = u.float()
    r = torch.sigmoid((u @ p["rg_a"]).float() + p["b_a"])
    i = torch.sigmoid((u @ p["rg_x"]).float() + p["b_x"])
    log_a = -cfg.rglru_c * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * uf)
    return a, b


def _rglru_block(cfg, p, h, *, mode, cache):
    rp = p["rnn"]
    x = norm(cfg, h, rp["ln"])
    u = x @ rp["w_in"]
    # jax.nn.gelu, which the reference calls, is the tanh approximation
    gate = F.gelu((x @ rp["w_gate"]).float(), approximate="tanh").to(x.dtype)
    u, new_conv = _causal_conv(rp["conv"], u, cache["conv"] if cache is not None else None)
    a, bdrive = _rglru_gates(cfg, rp, u)
    if mode == "decode":
        new_h = a[:, 0] * cache["h"] + bdrive[:, 0]
        hseq = new_h[:, None]
    else:
        h0 = cache["h"] if cache is not None else None
        hseq, new_h = rglru_ops.linear_recurrence(a, bdrive, h0, impl=_seq_impls(cfg)[0])
    h = h + (hseq.to(x.dtype) * gate) @ rp["w_out"]
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = _update(cache, {"h": new_h.float(), "conv": new_conv})
    return h, new_cache


# ---------------------------------------------------------------------------
# RWKV-6 block
# ---------------------------------------------------------------------------

def _token_shift(x, state):
    """xprev_t = x_{t-1}; the first position takes ``state`` (or zero)."""
    b, s, d = x.shape
    first = state[:, None] if state is not None else x.new_zeros((b, 1, d))
    if s == 1:
        return first
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_block(cfg, p, h, *, mode, cache):
    b, s, d = h.shape
    nh, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    # --- time mix ---
    x = norm(cfg, h, p["ln1"])
    xprev = _token_shift(x, cache["shift_tm"] if cache is not None else None)

    def mix(mu):
        return x + (xprev - x) * mu

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(b, s, nh, hd)
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(b, s, nh, hd)
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(b, s, nh, hd)
    g = mix(p["mu_g"]) @ p["w_g"]
    w_dyn = torch.tanh(mix(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp(p["w0"] + w_dyn.float(), -8.0, 8.0))
    w = torch.exp(logw).reshape(b, s, nh, hd)
    state = cache["wkv"] if cache is not None else None
    impl = "ref" if mode == "decode" else _seq_impls(cfg)[1]
    y, new_state = rwkv_ops.wkv6(r, k, v, w, p["u"], state, impl=impl)
    # per-head group norm, gate, out projection
    y = norm(cfg, y, torch.ones((hd,), dtype=y.dtype, device=y.device)).reshape(b, s, d)
    y = y * p["gn"].to(y.dtype)
    y = y * F.silu(g.float()).to(y.dtype)
    h = h + y @ p["w_o"]
    new_shift_tm = x[:, -1]
    # --- channel mix ---
    x2 = norm(cfg, h, p["ln2"])
    x2prev = _token_shift(x2, cache["shift_cm"] if cache is not None else None)

    def mix2(mu):
        return x2 + (x2prev - x2) * mu

    kc = torch.square(torch.relu((mix2(p["mu_ck"]) @ p["w_ck"]).float())).to(x2.dtype)
    rc = torch.sigmoid((mix2(p["mu_cr"]) @ p["w_cr"]).float()).to(x2.dtype)
    h = h + rc * (kc @ p["w_cv"])
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = _update(cache, {"wkv": new_state, "shift_tm": new_shift_tm,
                                    "shift_cm": x2[:, -1]})
    return h, new_cache


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

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
    enc_out: torch.Tensor | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, dict[str, Any] | None, torch.Tensor]:
    """Apply one block. Returns (h, new_cache, aux_loss); serving ignores the
    aux loss (``_no_aux``).  ``enc_out`` is the encoder output an ``xattn``
    block attends to in train and prefill; ``causal=False`` is the
    encoder's self-attention."""
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else None
        if mode == "decode":
            h, new_attn = _attn_core_decode(cfg, p, h, cache, pos, window=window)
        else:
            h, new_attn = _attn_core_train(cfg, p, h, rope, window=window, mode=mode,
                                           cache=cache, causal=causal)
        h, aux = _ffn_apply(cfg, p, h, mode)
        return h, new_attn, aux
    if kind == "xattn":
        if mode == "decode":
            h, new_self = _attn_core_decode(cfg, p["self"], h, cache["self"], pos, window=None)
        else:
            h, new_self = _attn_core_train(cfg, p["self"], h, rope, window=None, mode=mode,
                                           cache=cache["self"] if cache is not None else None)
        h, fresh = _cross_attn(cfg, p["cross"], h, enc_out=enc_out, mode=mode, cache=cache)
        new_cache = {"self": new_self, **fresh} if fresh is not None else cache
        h, aux = _ffn_apply(cfg, p, h, mode)
        return h, new_cache, aux
    if kind == "rglru":
        h, new_rnn = _rglru_block(cfg, p, h, mode=mode, cache=cache)
        h, aux = _ffn_apply(cfg, p, h, mode)
        return h, new_rnn, aux
    if kind == "rwkv":
        h, new_cache = _rwkv_block(cfg, p, h, mode=mode, cache=cache)
        return h, new_cache, _no_aux(h, mode)
    raise ValueError(f"unknown block kind {kind!r}")
