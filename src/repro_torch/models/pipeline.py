"""Transformer stacks as 1F1B pipeline stages.

Adapts the real model (``models.model`` / ``models.blocks``) to
:class:`repro_torch.dist.pipeline.PipelineStep`'s generalized schedule: the
stacked units become the homogeneous pipelined middle (one *pattern period*
— e.g. ``("rglru", "attn_local", "attn_local")`` — per pipeline slot), while
the token embedding and the final-norm + LM-head + loss are pinned to the
first and last ranks via the schedule's ``first_fn`` / ``last_fn`` hooks.
The hand-written kernels (flash attention, fused RMSNorm) dispatch inside
the staged computation exactly as in the non-pipelined forward —
``cfg.attn_impl`` / ``cfg.norm_impl`` select them per config — and their
``autograd.Function``s supply the backward of the stage recompute.  The
final norm is the config-dispatched ``norm`` here (the fused kernel under
``norm_impl="fused"``), as the reference's ``last_fn`` has it, where the
non-pipelined model always takes the unfused ``rms_norm``.

The contract mirrors ``models.model.loss_fn``: with every target valid and
equal-size microbatches, the 1F1B loss/grads match the non-pipelined
computation (1e-5 in f32).

Constraints checked by :func:`check_pipelineable`:
  * plain decoder LM (no encoder stack, no vision prefix),
  * dense blocks (``cfg.moe is None`` — the MoE aux loss is not plumbed
    through the per-stage loss accumulation),
  * ``n_layers`` divisible by the pattern length (no unrolled tail — every
    slot runs the same unit function),
  * ``cfg.loss_chunk`` unused here (the head sees one microbatch at a time).

In the process mode (one process a pipeline rank) a rank holds only some
pieces of the tree (:func:`piece_owners`): the units of its stage, the
embedding on rank 0, the final norm and the head on the last rank, and the
tied table on both ends.  :func:`split_params` and :func:`merge_grads`
then take the rank's share and give the rank's gradient; the tied table's
two gradient halves meet on both end ranks as ``first + last``, the single
controller's order, so its two copies take the same update.

``stage_param_specs`` composes the pipeline axis with the config's TP/FSDP
rules for the packed stack, as the reference's does; on a pod-only mesh
every inner entry drops, and ``dist.pipeline.PipelineStep`` refuses a spec
whose inner entries would shard (the reference's stage body is not
collective-aware).
"""

from __future__ import annotations

from typing import Any

import torch

from ..dist.sharding import PartitionSpec, ShardingRules, spec_for
from .blocks import norm
from .config import ArchConfig
from .layers import rotary_embedding, tree_map
from .model import (
    _ce_terms,
    _embed_tokens,
    _logits,
    _unit_apply,
    abstract_params,
    decoder_pattern,
    param_axes,
)

__all__ = [
    "check_pipelineable",
    "make_stage_fns",
    "piece_owners",
    "split_params",
    "merge_grads",
    "stage_param_specs",
]


def check_pipelineable(cfg: ArchConfig) -> int:
    """Validate ``cfg`` for stage pipelining; returns the unit (slot) count."""
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(
            f"family {cfg.family!r} is not pipelineable: encoder stacks / "
            f"vision prefixes need cross-stage inputs beyond the token stream"
        )
    if cfg.moe is not None:
        raise ValueError(
            "MoE configs are not pipelineable: the load-balance aux loss is "
            "not plumbed through the per-stage loss accumulation"
        )
    pattern = decoder_pattern(cfg)
    if cfg.n_layers % len(pattern) != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pattern "
            f"{pattern} (len {len(pattern)}): the unrolled tail has no slot"
        )
    n_units = cfg.n_layers // len(pattern)
    if n_units < 1:
        raise ValueError(f"need at least one pattern period, got {n_units}")
    return n_units


def make_stage_fns(cfg: ArchConfig, *, z_coef: float = 1e-4):
    """(layer_fn, first_fn, last_fn) for :class:`PipelineStep`.

    ``layer_fn(unit_params, h)`` applies one pattern period (the per-slot
    parameters are one slice of the model's ``scan`` tuple), without the
    model's ``cfg.remat``: the schedule's stage recompute is the remat;
    ``first_fn`` embeds a raw token microbatch; ``last_fn`` runs final norm
    + logits + the per-microbatch CE (+ z) loss — the same terms as
    ``models.model.loss_fn`` with ``aux_coef`` irrelevant (dense blocks).
    """
    check_pipelineable(cfg)
    pattern = decoder_pattern(cfg)
    ropes: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def layer_fn(unit_p, h):
        key = (h.shape[1], h.device)
        if key not in ropes:  # one table per sequence length and rank device
            ropes[key] = rotary_embedding(torch.arange(h.shape[1], device=h.device),
                                          cfg.resolved_head_dim, cfg.rope_theta)
        h, _, _ = _unit_apply(cfg, pattern, unit_p, h, rope=ropes[key], mode="train",
                              unit_cache=None, pos=None, enc_out=None, causal=True)
        return h

    def first_fn(fp, tokens):
        return _embed_tokens(cfg, fp, tokens)

    def last_fn(lp, h, targets):
        h = norm(cfg, h, lp["final_norm"])
        logits = _logits(cfg, lp, h)
        ce_sum, z_sum, n_valid = _ce_terms(cfg, logits, targets, z_coef)
        return (ce_sum + z_sum) / n_valid.clamp_min(1.0)

    return layer_fn, first_fn, last_fn


def piece_owners(cfg: ArchConfig, n_stages: int) -> dict[str, tuple[int, ...]]:
    """{top-level key of the params tree: the pipeline ranks that hold it}
    for every key but the unit stack ``"scan"``: the embedding on rank 0
    (and on the last rank when the head reads the tied table), the final
    norm and the head on the last rank, the (empty) tail on every rank."""
    last = n_stages - 1
    owners = {"embed": (0, last) if cfg.tied_embeddings and last else (0,),
              "final_norm": (last,), "tail": tuple(range(n_stages))}
    if not cfg.tied_embeddings:
        owners["lm_head"] = (last,)
    return owners


def split_params(cfg: ArchConfig, params, *, rank: int | None = None,
                 n_stages: int | None = None) -> tuple[Any, Any, Any]:
    """Split full model params into (stack, first_params, last_params).

    ``stack`` is the stacked unit tuple (leading dim = unit count) that
    :meth:`StagePlan.pack` pads into slots; ``first_params`` feeds the
    pinned embedding; ``last_params`` feeds the pinned head (the embed table
    rides along when embeddings are tied — its two gradient contributions
    are summed back in :func:`merge_grads`).

    With ``rank`` (the process mode) ``params`` is that rank's share
    (:func:`piece_owners`), ``stack`` its own units, and ``first_params``
    / ``last_params`` are ``None`` except on rank 0 / the last rank.
    """
    last_rank = rank is None or rank == n_stages - 1
    first = {"embed": params["embed"]} if rank is None or rank == 0 else None
    last: dict[str, Any] | None = None
    if last_rank:
        last = {"final_norm": params["final_norm"]}
        if cfg.tied_embeddings:
            last["embed"] = params["embed"]
        else:
            last["lm_head"] = params["lm_head"]
    return params["scan"], first, last


def merge_grads(cfg: ArchConfig, stack_grads, first_grads, last_grads, *,
                rank: int | None = None, n_stages: int | None = None, tied_peer=None):
    """Reassemble a full params-shaped gradient tree from the pipeline's
    (per-unit stack, first-stage, last-stage) gradient pieces.

    With ``rank`` (the process mode) the result is that rank's share, in
    the params tree's key order.  A tied table's gradient is ``first +
    last`` on both end ranks: ``tied_peer(half)`` sends this rank's half of
    it to the other end rank and returns that rank's half."""
    if rank is None:
        rank, n_stages = 0, 1
    last = n_stages - 1
    out: dict[str, Any] = {}
    if rank == 0 and not cfg.tied_embeddings:
        out["embed"] = first_grads["embed"]
    elif cfg.tied_embeddings and rank in (0, last):
        # tied table: gather grad (embedding) + matmul grad (head)
        first_half = first_grads["embed"] if rank == 0 else tied_peer(last_grads["embed"])
        last_half = last_grads["embed"] if rank == last else tied_peer(first_half)
        out["embed"] = tree_map(torch.add, first_half, last_half)
    if rank == last:
        out["final_norm"] = last_grads["final_norm"]
    out["scan"] = stack_grads
    out["tail"] = ()
    if rank == last and not cfg.tied_embeddings:
        out["lm_head"] = last_grads["lm_head"]
    return out


def stage_param_specs(cfg: ArchConfig, mesh: Any, rules: ShardingRules, axis: str = "pod"):
    """``PartitionSpec`` tree for the StagePlan-packed stack params.

    Every leaf's leading (slot) dimension maps to the pipeline ``axis``; the
    trailing parameter dimensions compose the model's logical axes through
    ``spec_for``'s TP/FSDP rules with the usual drop semantics — on a
    pod-only pipeline mesh every inner entry drops and the result is plain
    ``P(axis)`` (replicated within a stage, which is what the stage-local
    compute assumes).
    """
    axes = param_axes(cfg)["scan"]
    shapes = abstract_params(cfg)["scan"]

    def one(ax, spec):
        inner = spec_for(tuple(ax)[1:], tuple(spec.shape)[1:], mesh, rules)
        return PartitionSpec(axis, *inner)

    return tree_map(one, axes, shapes)
