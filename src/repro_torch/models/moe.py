"""Mixture-of-Experts FFN of the PyTorch port: top-k token-choice routing with
static capacity, the counterpart of the reference's ``models/moe.py``.

Dispatch is gather-based: tokens are packed into an (E, C) slot buffer per
routing group through a sentinel row, the experts run as batched matrix
products over the expert axis, and each token gathers its kept slots'
outputs back and adds them in expert order, in the activation dtype: the
values of the reference's scatter-add, in the same order.  Tokens beyond an
expert's capacity ``C = ceil(top_k·S·cf/E)`` are dropped (their residual
passes through).  Every step is a fixed number of
tensor operations batched over groups and experts, with no Python loop over
either: 64 experts x 48 layers of per-expert launches would make a decode
step host-bound.

Router math in f32; Switch-style load-balancing aux loss, which the model
sums over the layers into the training loss.  The expert products are
library GEMMs: the reference computes them outside any Pallas kernel.  The
backward is autograd's, through the routing's gathers, the dispatch and
combine gathers and the batched GEMMs; on the card it repeats its bits
(the gathers' backward accumulates duplicate rows in a sorted, fixed
order).  The reference's ``constrain`` calls are sharding hints that do
nothing on one device; ``cfg.moe_dispatch_mode``, which picks between them,
is kept as a config field and ignored here until the port distributes
(ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import PSpec

__all__ = ["moe_specs", "moe_apply", "route", "Routing"]


def moe_specs(cfg: ArchConfig, stack: tuple[int, ...] = ()) -> dict[str, PSpec]:
    assert cfg.moe is not None
    d, e, de = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    lead = tuple(stack)
    lax_ = ("layers",) * len(stack)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {
        "router": PSpec(lead + (d, e), lax_ + ("embed", "expert"), dtype=torch.float32),
        "wi": PSpec(lead + (e, d, de), lax_ + ("expert", "embed", "expert_ffn"), dtype=dtype),
        "wg": PSpec(lead + (e, d, de), lax_ + ("expert", "embed", "expert_ffn"), dtype=dtype),
        "wo": PSpec(lead + (e, de, d), lax_ + ("expert", "expert_ffn", "embed"), dtype=dtype),
    }


class Routing(NamedTuple):
    """The routing of G groups of S tokens over E experts at capacity C."""

    gates: torch.Tensor  # (G, S, E) f32 softmax of the router logits
    top_i: torch.Tensor  # (G, S, k) chosen experts, by falling gate
    weights: torch.Tensor  # (G, S, E) f32 renormalised gate of each choice, else 0
    mask: torch.Tensor  # (G, S, E) int32: the token chose the expert
    keep: torch.Tensor  # (G, S, E) bool: ... and got a slot (not dropped)
    pos: torch.Tensor  # (G, S, E) the choice's slot (>= C when dropped)
    token_idx: torch.Tensor  # (G, E, C) token in each slot; S = empty (sentinel)


def _capacity(cfg: ArchConfig, s: int) -> int:
    moe = cfg.moe
    cap = max(math.ceil(moe.top_k * s * moe.capacity_factor / moe.n_experts), 1)
    return min(cap, s)


def route(cfg: ArchConfig, router: torch.Tensor, x: torch.Tensor,
          top_i: torch.Tensor | None = None) -> Routing:
    """Route x (G, S, D): each group's tokens take slots in token order.

    ``top_i`` (G, S, k), when given, replaces the top-k choice: the gates
    and the renormalised weights are still this call's own.  A comparison of
    two paths passes one path's choices to the other, so that a near-tie
    their rounding breaks differently does not move a token."""
    g, s, _ = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = _capacity(cfg, s)
    gates = torch.softmax(x.float() @ router, dim=-1)
    if top_i is None:
        top_v, top_i = torch.topk(gates, k, dim=-1)
    else:
        top_v = gates.gather(-1, top_i)
    top_v = top_v / torch.clamp_min(top_v.sum(-1, keepdim=True), 1e-9)
    weights = torch.zeros((g, s, e), dtype=torch.float32, device=x.device)
    weights.scatter_add_(-1, top_i, top_v)
    mask = (weights > 0).to(torch.int32)
    pos = torch.cumsum(mask, dim=1) - 1
    keep = (mask == 1) & (pos < cap)
    slot = torch.where(keep, pos, cap)  # overflow slot, sliced off below
    token_idx = torch.full((g, e, cap + 1), s, dtype=torch.int64, device=x.device)
    tokens = torch.arange(s, device=x.device).expand(g, e, s)
    token_idx.scatter_(-1, slot.transpose(1, 2), tokens)
    return Routing(gates, top_i, weights, mask, keep, pos, token_idx[..., :cap])


def _moe_grouped(cfg: ArchConfig, p: dict[str, torch.Tensor], x: torch.Tensor):
    g, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    r = route(cfg, p["router"], x)
    cap = r.token_idx.shape[-1]
    groups = torch.arange(g, device=x.device)[:, None, None]
    # dispatch: each slot gathers its token, an empty one the zero sentinel row
    rows = (r.token_idx + (s + 1) * groups).transpose(0, 1).reshape(-1)  # (E, G, C)
    xe = F.pad(x, (0, 0, 0, 1)).reshape(g * (s + 1), d)[rows].reshape(e, g * cap, d)
    up = torch.bmm(xe, p["wi"])
    gate = torch.bmm(xe, p["wg"])
    hidden = F.silu(gate.float()).to(xe.dtype) * up
    ye = F.pad(torch.bmm(hidden, p["wo"]).reshape(e * g * cap, d), (0, 0, 0, 1))
    # combine: each token adds its kept choices' weighted outputs in the
    # activation dtype, in expert order, the order of the reference's
    # scatter-add; a gather, so the sum is the same on every run (atomic adds
    # on the card are not); a dropped choice reads the zero row past the end
    chosen = torch.sort(r.top_i, dim=-1).values  # (G, S, k)
    slot_row = (chosen * g + groups) * cap + r.pos.gather(-1, chosen)
    slot_row = torch.where(r.keep.gather(-1, chosen), slot_row, e * g * cap)
    contrib = (ye[slot_row].float() * r.weights.gather(-1, chosen)[..., None]).to(x.dtype)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    # Switch load-balancing loss: E * sum_e f_e * mean gate_e
    frac = r.mask.float().mean(dim=(0, 1))
    prob = r.gates.mean(dim=(0, 1))
    return y, e * torch.sum(frac * prob)


def moe_apply(
    cfg: ArchConfig, p: dict[str, torch.Tensor], x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Routing groups: for S > 1 each batch row is its own group.  For decode
    (S == 1) the whole batch is one group, as in the reference: with
    per-row groups every row would run all E experts at capacity 1.
    """
    b, s, d = x.shape
    if s == 1 and b > 1:
        y, aux = _moe_grouped(cfg, p, x.reshape(1, b, d))
        return y.reshape(b, 1, d), aux
    return _moe_grouped(cfg, p, x)
