"""Model API of the PyTorch port (dense, MoE, hybrid, SSM, vlm and enc-dec stacks).

Parameters are the reference's pytree as plain nested dicts/tuples of
tensors: per-layer weights stacked along a leading ``"scan"`` axis of pattern
periods (applied by a Python loop over that axis), then the unstacked
``"tail"`` layers.

Public surface:
    model_specs(cfg)                          -> PSpec tree (params, never allocated)
    abstract_params(cfg)                      -> the same PSpec tree (shapes, dtypes)
    param_axes(cfg)                           -> logical-axes tree of the params
    init_params(cfg, generator, device)       -> concrete params
    cache_specs(cfg, batch, max_seq)          -> PSpec tree (decode cache)
    cache_axes(cfg, batch, max_seq)           -> logical-axes tree of the cache
    init_cache(cfg, batch, max_seq, device)   -> zeroed decode cache
    param_counts(cfg)                         -> (total, active) parameter counts
    forward(cfg, params, batch)               -> logits (B, S, padded_vocab)
    loss_fn(cfg, params, batch)               -> (loss, metrics)
    prefill(cfg, params, batch, cache)        -> (cache, last_logits)
    decode_step(cfg, params, cache, tokens)   -> (cache, logits)
    prefix_positions(cfg)                     -> cache positions of a vlm's patch prefix

A vlm batch carries ``patch_embeds`` (B, n_vision_patches, d_model), the
stub vision frontend's output: ``forward``, ``loss_fn`` and ``prefill`` run
the stack over the patches followed by the text tokens, and ``forward`` and
``loss_fn`` score text positions only, as the reference does: index j of
their output is the position before text token j (the last patch for
j = 0), so with next-token targets the position that has seen text tokens
0..j-1 is scored on token j+1.  ``decode_step`` needs no prefix: the cache
holds it.

An encdec batch carries ``src_frames`` (B, T, d_model), the stub audio
frontend's output: ``forward``, ``loss_fn`` and ``prefill`` first run the
encoder (``enc_scan``: ``attn`` blocks, not causal, rotary over source
positions, then the unfused ``enc_final_norm``) over them, and every decoder
block (``xattn``) attends to its output.  The encoder's arithmetic is
the same in training and prefill, as the reference's is (its
``mode="train"`` from prefill too): under ``cfg.remat`` in training; in
prefill as blocks without a cache, which add no aux loss.  A prefill fills
each layer's cross K/V and source length into the cache, so ``decode_step``
needs no encoder.

Under ``dist.context.use_sharding`` with DTensor params and batch, the
``constrain`` calls the reference makes (the embedding, the logits, the
attention output, the MoE dispatch) pin those activations to the placements
their logical axes resolve to; outside a context they do nothing.  Under
FSDP rules ``loss_fn`` gathers the parameters' width for compute
(``dist.context.gather_fsdp``), so the gradient comes back reduce-scattered
to the stored shards.

Entry points that allocate take ``device`` (default ``"cuda"``).  Prefill and
decode update the tensors of the cache they are given in place (K/V, ring
slots, recurrent states) and return that cache with a new ``pos``.

In ``mode="train"`` each stacked unit runs under ``cfg.remat``: ``"none"``
keeps every activation; ``"full"`` is ``torch.utils.checkpoint`` per unit
(only the unit's input is kept, its forward runs again in the backward);
``"dots"`` is selective checkpointing that keeps the outputs of the weight
matmuls (``aten.mm``, the reference's "dots with no batch dims") and
recomputes everything else, attention and norms included.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from ..dist.context import constrain, gather_fsdp, is_dtensor, local_apply, placements_of
from .blocks import block_apply, block_cache_specs, block_specs
from .config import ArchConfig
from .layers import (
    PSpec,
    axes_tree,
    materialize,
    rms_norm,
    rotary_embedding,
    tree_leaves,
    tree_map,
)

__all__ = [
    "model_specs",
    "abstract_params",
    "param_axes",
    "init_params",
    "param_counts",
    "cache_specs",
    "cache_axes",
    "init_cache",
    "decoder_pattern",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "prefix_positions",
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


# ---------------------------------------------------------------------------
# Parameter and cache specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ArchConfig) -> dict[str, Any]:
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
    if cfg.family == "encdec":
        n_enc = cfg.n_enc_layers
        specs["enc_scan"] = (block_specs(cfg, "attn", (n_enc,)),) if n_enc else None
        specs["enc_final_norm"] = PSpec((d,), (None,), init="ones", dtype=dt)
    return specs


def abstract_params(cfg: ArchConfig):
    """The parameters' shapes and dtypes without allocating them: the
    ``PSpec`` tree (each leaf has ``.shape`` and ``.dtype``)."""
    return model_specs(cfg)


def param_axes(cfg: ArchConfig):
    """Logical-axes tree of the parameters (``Axes`` leaves)."""
    return axes_tree(model_specs(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator, device: str | torch.device = "cuda"):
    """Seeded random weights on ``device`` (draws from ``generator``)."""
    return materialize(model_specs(cfg), generator, device)


def param_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) — active scales expert weights by top_k / n_experts and
    excludes embedding/lm_head (6·N·D convention counts matmul params)."""
    total = 0
    active = 0

    def walk(tree, keys):
        nonlocal total, active
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, keys + (k,))
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                walk(v, keys)
        elif isinstance(tree, PSpec):
            n = 1
            for dim in tree.shape:
                n *= int(dim)
            total += n
            if "embed" in keys or "lm_head" in keys:
                return
            if cfg.moe is not None and "moe" in keys and any(k in ("wi", "wg", "wo") for k in keys):
                active += int(n * cfg.moe.top_k / cfg.moe.n_experts)
            else:
                active += n

    walk(model_specs(cfg), ())
    return total, active


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict[str, Any]:
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


def _unstack(tree: Any, n: int) -> list[Any]:
    """A tree of stacked (n, ...) leaves -> n trees of per-unit views, one
    ``unbind`` per leaf: its backward is a single ``stack``, where indexing
    ``x[i]`` per unit would add a zero-filled copy of the whole stacked leaf
    per unit to the gradient."""
    if tree is None:
        return [None] * n
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    units = []
    for i in range(n):
        it = iter(p[i] for p in parts)
        units.append(tree_map(lambda _: next(it), tree))
    return units


def _keep_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep weight matmul
    outputs, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """Wrap one stacked unit's forward ``fn(h) -> (h, aux)`` in ``cfg.remat``.
    The checkpoints are non-reentrant, so ``fn`` may close over tensors that
    need gradients (the encoder output a decoder unit attends to): the
    gradient reaches them through the recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda h: ckpt.checkpoint(fn, h, use_reentrant=False)
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _keep_matmuls)
        return lambda h: ckpt.checkpoint(fn, h, use_reentrant=False, context_fn=context)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _unit_apply(cfg, kinds, unit_p, h, *, rope, mode, unit_cache, pos, enc_out, causal):
    """One stacked unit: the blocks of ``kinds`` in order.  Returns (h, the
    blocks' caches, aux): in ``mode="train"`` the f32 sum of the blocks' aux
    losses, else None (no additions launched for it)."""
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device) if mode == "train" else None
    for i, kind in enumerate(kinds):
        c = unit_cache[i] if unit_cache is not None else None
        h, nc, a = block_apply(cfg, kind, unit_p[i], h, rope=rope, mode=mode, cache=c, pos=pos,
                               enc_out=enc_out, causal=causal)
        new_caches.append(nc)
        if mode == "train":
            aux = aux + a
    return h, tuple(new_caches), aux


def _apply_stack(cfg, params, h, *, rope, mode, caches=None, pos=None, encoder=False,
                 enc_out=None):
    """Run the stacked units (a loop over the leading ``scan`` axis), then the
    tail; with ``encoder`` the encoder's units (``enc_scan``, no tail, not
    causal) instead, in ``mode="train"`` or, keeping no cache, ``"prefill"``.
    ``enc_out`` is what the decoder's ``xattn`` blocks attend to in train and
    prefill.  Returns (h, {"scan", "tail"} caches, aux): the given caches,
    updated in place, or — for a decoder prefill without caches — freshly
    stacked ones; None in ``mode="train"``, where each unit runs under
    ``cfg.remat``, and for the encoder.
    In ``mode="train"``, ``aux`` is the f32 sum of every layer's aux loss,
    unit by unit and then over the tail, in the reference's order; prefill
    and decode need none and return None (no additions launched for it)."""
    if encoder:
        n_scan, pattern, tail_kinds = cfg.n_enc_layers, ("attn",), ()
    else:
        n_scan, pattern, tail_kinds = _split_stack(cfg)
    p_scan = params["enc_scan" if encoder else "scan"]
    n_units = n_scan if p_scan is not None else 0
    run = dict(rope=rope, mode=mode, enc_out=enc_out, causal=not encoder)
    c_scan = caches["scan"] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device) if mode == "train" else None
    fresh_scan = []
    for i, unit_p in enumerate(_unstack(p_scan, n_units)):
        if mode == "train":

            def unit(x, unit_p=unit_p):
                x, _, unit_aux = _unit_apply(cfg, pattern, unit_p, x, unit_cache=None, pos=None,
                                             **run)
                return x, unit_aux

            h, a = _remat(cfg, unit)(h)
            aux = aux + a
            continue
        unit_c = tree_map(lambda x: x[i], c_scan)  # views: written in place
        h, unit_new, _ = _unit_apply(cfg, pattern, unit_p, h, unit_cache=unit_c, pos=pos, **run)
        if not encoder:  # its K/V are not kept
            fresh_scan.append(unit_new)
    if encoder:
        return h, None, aux
    fresh_tail = []
    for i, (kind, bp) in enumerate(zip(tail_kinds, params["tail"])):
        c = caches["tail"][i] if caches is not None else None
        h, nc, a = block_apply(cfg, kind, bp, h, cache=c, pos=pos, **run)
        fresh_tail.append(nc)
        if mode == "train":
            aux = aux + a
    if mode == "train":
        return h, None, aux
    if caches is not None:
        return h, {"scan": caches["scan"], "tail": caches["tail"]}, aux
    return h, {
        "scan": _stack_trees(fresh_scan) if fresh_scan else None,
        "tail": tuple(fresh_tail),
    }, aux


def _embed_tokens(cfg: ArchConfig, params, tokens):
    table = params["embed"]["tokens"]
    if cfg.embed_gather_constraint:
        # pre-reshard: keep vocab sharded, gather the (FSDP-sharded) embed
        # dim first, as the reference does
        table = constrain(table, "vocab", None)
    x = _local_lookup(table, tokens) if is_dtensor(table) else table[tokens]
    return constrain(x, "batch", "seq", None)


def _local_lookup(table, tokens):
    """``table[tokens]`` of a DTensor table on each rank's shards, as a
    vocabulary-parallel embedding: the table keeps its vocabulary shards
    (its width is gathered), the tokens their batch shards; each rank looks
    up the tokens in its own rows and zeroes the others, so the rows add up
    (``Partial``) over the vocabulary shards.  The table's gradient is each
    rank's part of the sum over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    k_pl = placements_of(tokens, replicate_dims=(1,))
    # a mesh axis that shards the batch holds the whole vocabulary
    t_pl = tuple(Replicate() if kp == Shard(0) else tp
                 for tp, kp in zip(placements_of(table, replicate_dims=(1,)), k_pl))
    out = tuple(Shard(0) if kp == Shard(0) else Partial() if tp == Shard(0) else Replicate()
                for tp, kp in zip(t_pl, k_pl))
    grad = tuple(Partial() if kp == Shard(0) else tp for tp, kp in zip(t_pl, k_pl))
    shard = 0
    for i, p in enumerate(t_pl):  # this rank's vocabulary shard, major axis first
        if p == Shard(0):
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)

    def lookup(tab, tok):
        first = shard * tab.shape[0]
        inside = (tok >= first) & (tok < first + tab.shape[0])
        rows = tab[(tok - first).clamp(0, tab.shape[0] - 1)]
        return rows.masked_fill(~inside[..., None], 0)

    return local_apply(lookup, [(table, t_pl, grad), (tokens, k_pl, None)], [out], mesh=mesh)


def prefix_positions(cfg: ArchConfig) -> int:
    """Positions a prefill runs, and a cache holds, before a prompt's text:
    the vlm family's patch embeddings, none for the others."""
    return cfg.n_vision_patches if cfg.family == "vlm" else 0


def _build_inputs(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, int]:
    """The embedded input of train and prefill, (h, n_prefix): for vlm the
    patch embeddings, cast to the model's dtype, in front of the text's."""
    text = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(text.dtype)
        return torch.cat([patches, text], dim=1), patches.shape[1]
    return text, 0


def _logits(cfg, params, h):
    if cfg.tied_embeddings:
        table = params["embed"]["tokens"]
        if cfg.embed_gather_constraint:
            table = constrain(table, "vocab", None)
        logits = h @ table.T
    else:
        head = params["lm_head"]
        if cfg.embed_gather_constraint:
            head = constrain(head, None, "vocab")
        logits = h @ head
    return constrain(logits, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Forward / prefill / decode entry points
# ---------------------------------------------------------------------------

def _rope(cfg, s: int, device):
    return rotary_embedding(torch.arange(s, device=device), cfg.resolved_head_dim, cfg.rope_theta)


def _encode(cfg: ArchConfig, params, batch, *, training: bool) -> torch.Tensor | None:
    """The encoder output over ``batch["src_frames"]`` (cast to the model's
    dtype) for an encdec config, else None: the stack under ``cfg.remat``
    when ``training``, else as prefill blocks without a cache (the same
    arithmetic, with no aux loss and no remat), then the unfused
    ``enc_final_norm``."""
    if cfg.family != "encdec":
        return None
    src = batch["src_frames"].to(_dtype(cfg))
    h, _, _ = _apply_stack(cfg, params, src, rope=_rope(cfg, src.shape[1], src.device),
                           mode="train" if training else "prefill", encoder=True)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _hidden(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to and including the final norm, at the text
    positions (a vlm prefix rebased as the reference's ``_hidden_for_loss``
    does); returns (h, the stack's summed aux loss)."""
    enc_out = _encode(cfg, params, batch, training=True)
    h, n_prefix = _build_inputs(cfg, params, batch)
    rope = _rope(cfg, h.shape[1], h.device)
    h, _, aux = _apply_stack(cfg, params, h, rope=rope, mode="train", enc_out=enc_out)
    if n_prefix:
        # the final norm is per row: slicing before it gives the same bits
        h = h[:, n_prefix - 1 : n_prefix - 1 + batch["tokens"].shape[1]]
    # the final norm is always the unfused rms_norm, whatever norm_impl says
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def forward(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Full-sequence forward. Returns logits (B, S, padded_vocab), S the
    text tokens."""
    return _logits(cfg, params, _hidden(cfg, params, batch)[0])


def _ce_terms(cfg: ArchConfig, logits, targets, z_coef: float):
    """(Σ ce, Σ z, Σ valid) over one logits block; f32, padded vocab masked.
    DTensor logits go through ``_local_ce_terms``."""
    if is_dtensor(logits):
        return _local_ce_terms(cfg, logits, targets, z_coef)
    lf = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.arange(cfg.padded_vocab, device=lf.device) < cfg.vocab_size
        lf = lf.masked_fill(~vmask, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    valid = (targets >= 0).float()
    return (
        ((lse - gold) * valid).sum(),
        z_coef * (lse.square() * valid).sum(),
        valid.sum(),
    )


def _local_ce_terms(cfg: ArchConfig, logits, targets, z_coef: float):
    """``_ce_terms`` of DTensor logits on each rank's rows: the batch stays
    sharded where the logits' is (the targets follow it), the vocabulary is
    gathered, so each row's log-sum-exp is the unsharded one; the three sums
    are each rank's part (``Partial``) over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = placements_of(logits, replicate_dims=tuple(range(1, logits.ndim)))
    parts = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    return local_apply(lambda lg, tg: _ce_terms(cfg, lg, tg, z_coef),
                       [(logits, rows, None), (targets, rows, None)], [parts] * 3,
                       mesh=logits.device_mesh)


def loss_fn(cfg: ArchConfig, params, batch, aux_coef: float = 0.01, z_coef: float = 1e-4):
    """Mean next-token cross-entropy over the valid targets (``targets >= 0``)
    plus the z-loss; returns (loss, metrics).  With ``cfg.loss_chunk`` dividing
    the sequence, the logits and CE of each chunk are computed under
    ``torch.utils.checkpoint``, so the (B, S, V) logits never materialize.
    ``aux`` is the stack's summed aux loss (the MoE routers' load-balancing
    loss; 0 for a stack without experts), added as ``aux_coef * aux``."""
    targets = batch["targets"]
    chunk = cfg.loss_chunk
    params = gather_fsdp(params)  # FSDP-sharded weights, whole for compute
    h, aux = _hidden(cfg, params, batch)
    s = targets.shape[1]
    if chunk and s % chunk == 0 and s > chunk:

        def body(hb, tb):
            return torch.stack(_ce_terms(cfg, _logits(cfg, params, hb), tb, z_coef))

        sums = sum(
            ckpt.checkpoint(body, h[:, i : i + chunk], targets[:, i : i + chunk],
                            use_reentrant=False)
            for i in range(0, s, chunk)
        )
        ce_sum, z_sum, n_valid = sums.unbind(0)
    else:
        ce_sum, z_sum, n_valid = _ce_terms(cfg, _logits(cfg, params, h), targets, z_coef)
    n_valid = n_valid.clamp_min(1.0)
    ce = ce_sum / n_valid
    z_loss = z_sum / n_valid
    loss = ce + z_loss + aux_coef * aux
    metrics = {"loss": loss, "ce": ce, "aux": aux, "z_loss": z_loss, "tokens": n_valid}
    return loss, metrics


def prefill(cfg: ArchConfig, params, batch, cache):
    """Fill the decode cache from a full prompt (behind its patch prefix for
    vlm; with the encoder output's cross K/V for encdec); returns (cache,
    last_logits)."""
    enc_out = _encode(cfg, params, batch, training=False)
    h, _ = _build_inputs(cfg, params, batch)
    s = h.shape[1]
    rope = _rope(cfg, s, h.device)
    h, new_caches, _ = _apply_stack(cfg, params, h, rope=rope, mode="prefill", caches=cache,
                                    enc_out=enc_out)
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
    h = _embed_tokens(cfg, params, tokens)
    h, new_caches, _ = _apply_stack(cfg, params, h, rope=None, mode="decode", caches=cache,
                                    pos=pos)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, h)
    new_cache = {"pos": pos + 1, "scan": new_caches["scan"], "tail": new_caches["tail"]}
    return new_cache, logits[:, 0]
