"""AdamW with mixed precision: bf16 params, f32 master + moments, global-norm
clipping.  Written against plain parameter trees (nested dicts/tuples of
tensors), as the reference is against pytrees; this is not
``torch.optim.AdamW``, which keeps no f32 master copy of bf16 parameters.

Unlike the reference, whose arrays are immutable, :func:`adamw_update`
updates the optimizer state's ``m``, ``v`` and ``master`` tensors in place
(at full width each is as large as the model in f32, so fresh copies would
double the optimizer's memory for the length of the update) and returns that
state with a new ``step``; the returned parameters are fresh tensors cast
from the master weights.

Trees of DTensors (a sharded step, ``launch.steps.make_train_step`` with a
mesh) update shard by shard: every leaf's state has its parameter's
placements, and :func:`global_norm` reduces each leaf's sum of squares to a
replicated scalar before adding them up, so the clipped norm is the
unsharded one on every rank.  The update runs inside the step's sharding
context, where the plain scalars (``lr``, the bias corrections) count as
replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..dist.context import is_dtensor
from ..models.layers import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm", "opt_state_axes"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    #: keep an f32 master copy of bf16 params (standard mixed precision)
    master_weights: bool = True


def init_opt_state(cfg: AdamWConfig, params) -> dict[str, Any]:
    """``step`` (int32 scalar), f32 zero moments ``m``/``v``, and with
    ``master_weights`` an f32 ``master`` copy of the params, on their device."""
    # zeros_like keeps a DTensor parameter's placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.master_weights:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def opt_state_axes(cfg: AdamWConfig, axes):
    """Logical axes for the optimizer state, mirroring the parameter axes."""
    state = {"step": (), "m": axes, "v": axes}
    if cfg.master_weights:
        state["master"] = axes
    return state


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of one leaf; of a DTensor, the whole tensor's,
    as a plain tensor on every rank (each shard's sum, then all of them
    added up)."""
    total = x.float().square().sum()
    return total.full_tensor() if is_dtensor(total) else total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(torch.stack([_square_sum(x) for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params, grads, opt_state, lr: torch.Tensor,
    gnorm: torch.Tensor | None = None,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """One AdamW step. Returns (params, opt_state, stats); see the module
    docstring for what is updated in place.  ``gnorm`` replaces
    :func:`global_norm` of ``grads`` as the norm clipped by (the pipelined
    steps pass the norm of the whole model's gradient, of which ``grads``
    may be one rank's share)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    masters = opt_state.get("master")
    if masters is None:
        masters = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    for g, m, v, mw in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                           tree_leaves(opt_state["v"]), tree_leaves(masters)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * mw
        mw.sub_(lr * upd)
    params_new = tree_map(lambda mw, p: mw.to(p.dtype, copy=True), masters, params)
    new_state = {"step": step, "m": opt_state["m"], "v": opt_state["v"]}
    if cfg.master_weights:
        new_state["master"] = masters
    stats = {"grad_norm": gnorm, "clip_scale": scale}
    return params_new, new_state, stats
