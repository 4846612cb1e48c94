"""Model API of the PyTorch port (dense decoder stacks).

Parameters are the reference's pytree as plain nested dicts/tuples of
tensors: per-layer weights stacked along a leading ``"scan"`` axis of pattern
periods (applied by a Python loop over that axis), then the unstacked
``"tail"`` layers.

Public surface:
    model_specs(cfg)                          -> PSpec tree (params, never allocated)
    init_params(cfg, generator, device)       -> concrete params
    cache_specs(cfg, batch, max_seq)          -> PSpec tree (decode cache)
    cache_axes(cfg, batch, max_seq)           -> logical-axes tree of the cache
    init_cache(cfg, batch, max_seq, device)   -> zeroed decode cache
    forward(cfg, params, batch)               -> logits (B, S, padded_vocab)
    prefill(cfg, params, batch, cache)        -> (cache, last_logits)
    decode_step(cfg, params, cache, tokens)   -> (cache, logits)

Entry points that allocate take ``device`` (default ``"cuda"``).  Prefill and
decode update the K/V tensors of the cache they are given in place and return
that cache with a new ``pos``.  ``loss_fn`` comes with the training slice.
"""

from __future__ import annotations

from typing import Any

import torch

from .blocks import block_apply, block_cache_specs, block_specs
from .config import ArchConfig
from .layers import PSpec, axes_tree, materialize, rms_norm, rotary_embedding, tree_map

__all__ = [
    "model_specs",
    "init_params",
    "cache_specs",
    "cache_axes",
    "init_cache",
    "decoder_pattern",
    "forward",
    "prefill",
    "decode_step",
]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def decoder_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    """Block pattern of the decoder stack (enc-dec decoders use xattn blocks)."""
    return ("xattn",) if cfg.family == "encdec" else cfg.block_pattern


def _split_stack(cfg: ArchConfig) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
    """(n_scan_units, pattern, tail_kinds) for the decoder stack."""
    pattern = decoder_pattern(cfg)
    p = len(pattern)
    n_scan = cfg.n_layers // p
    tail = tuple(pattern[i % p] for i in range(n_scan * p, cfg.n_layers))
    return n_scan, pattern, tail


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported (ROADMAP Queue 1: MoE, encdec, vlm)"
        )


# ---------------------------------------------------------------------------
# Parameter and cache specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ArchConfig) -> dict[str, Any]:
    _check_family(cfg)
    dt = _dtype(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    n_scan, pattern, tail = _split_stack(cfg)
    specs: dict[str, Any] = {
        "embed": {"tokens": PSpec((vp, d), ("vocab", "embed"), scale=0.02, dtype=dt)},
        "final_norm": PSpec((d,), (None,), init="ones", dtype=dt),
        "scan": tuple(block_specs(cfg, k, (n_scan,)) for k in pattern) if n_scan else None,
        "tail": tuple(block_specs(cfg, k) for k in tail),
    }
    if not cfg.tied_embeddings:
        specs["lm_head"] = PSpec((d, vp), ("embed", "vocab"), dtype=dt)
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator, device: str | torch.device = "cuda"):
    """Seeded random weights on ``device`` (draws from ``generator``)."""
    return materialize(model_specs(cfg), generator, device)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict[str, Any]:
    _check_family(cfg)
    n_scan, pattern, tail = _split_stack(cfg)
    return {
        "pos": PSpec((batch,), ("batch",), init="zeros", dtype=torch.int32),
        "scan": tuple(
            block_cache_specs(cfg, k, batch, max_seq, (n_scan,)) for k in pattern
        )
        if n_scan
        else None,
        "tail": tuple(block_cache_specs(cfg, k, batch, max_seq) for k in tail),
    }


def cache_axes(cfg: ArchConfig, batch: int, max_seq: int):
    return axes_tree(cache_specs(cfg, batch, max_seq))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device: str | torch.device = "cuda"):
    return materialize(cache_specs(cfg, batch, max_seq), None, device)


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def _stack_trees(trees: list[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _apply_stack(cfg, params, h, *, rope, mode, caches=None, pos=None):
    """Run the stacked units (a loop over the leading ``scan`` axis), then the
    tail.  Returns (h, {"scan", "tail"} caches): the given caches, updated in
    place, or — for a prefill without caches — freshly stacked ones."""
    n_scan, pattern, tail_kinds = _split_stack(cfg)
    p_scan = params["scan"]
    c_scan = caches["scan"] if caches is not None else None
    fresh_scan = []
    for i in range(n_scan if p_scan is not None else 0):
        unit_p = tree_map(lambda x: x[i], p_scan)
        unit_c = tree_map(lambda x: x[i], c_scan)
        unit_new = []
        for j, kind in enumerate(pattern):
            c = unit_c[j] if unit_c is not None else None
            h, nc = block_apply(cfg, kind, unit_p[j], h, rope=rope, mode=mode, cache=c, pos=pos)
            unit_new.append(nc)
        fresh_scan.append(tuple(unit_new))
    fresh_tail = []
    for i, (kind, bp) in enumerate(zip(tail_kinds, params["tail"])):
        c = caches["tail"][i] if caches is not None else None
        h, nc = block_apply(cfg, kind, bp, h, rope=rope, mode=mode, cache=c, pos=pos)
        fresh_tail.append(nc)
    if mode == "train":
        return h, None
    if caches is not None:
        return h, {"scan": caches["scan"], "tail": caches["tail"]}
    return h, {
        "scan": _stack_trees(fresh_scan) if fresh_scan else None,
        "tail": tuple(fresh_tail),
    }


def _embed_tokens(params, tokens):
    return params["embed"]["tokens"][tokens]


def _logits(cfg, params, h):
    if cfg.tied_embeddings:
        return h @ params["embed"]["tokens"].T
    return h @ params["lm_head"]


# ---------------------------------------------------------------------------
# Forward / prefill / decode entry points
# ---------------------------------------------------------------------------

def _rope(cfg, s: int, device):
    return rotary_embedding(torch.arange(s, device=device), cfg.resolved_head_dim, cfg.rope_theta)


def forward(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Full-sequence forward. Returns logits (B, S, padded_vocab)."""
    h = _embed_tokens(params, batch["tokens"])
    rope = _rope(cfg, h.shape[1], h.device)
    h, _ = _apply_stack(cfg, params, h, rope=rope, mode="train")
    # the final norm is always the unfused rms_norm, whatever norm_impl says
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h)


def prefill(cfg: ArchConfig, params, batch, cache):
    """Fill the decode cache from a full prompt; returns (cache, last_logits)."""
    h = _embed_tokens(params, batch["tokens"])
    s = h.shape[1]
    rope = _rope(cfg, s, h.device)
    h, new_caches = _apply_stack(cfg, params, h, rope=rope, mode="prefill", caches=cache)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, h)
    new_cache = {
        "pos": torch.full((h.shape[0],), s, dtype=torch.int32, device=h.device),
        "scan": new_caches["scan"],
        "tail": new_caches["tail"],
    }
    return new_cache, logits[:, 0]


def decode_step(cfg: ArchConfig, params, cache, tokens):
    """One decode step. tokens: (B, 1). Returns (cache, logits (B, padded_vocab))."""
    pos = cache["pos"]
    h = _embed_tokens(params, tokens)
    h, new_caches = _apply_stack(cfg, params, h, rope=None, mode="decode", caches=cache, pos=pos)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, h)
    new_cache = {"pos": pos + 1, "scan": new_caches["scan"], "tail": new_caches["tail"]}
    return new_cache, logits[:, 0]
