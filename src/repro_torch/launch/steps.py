"""Step builders of the port: the training step, without sharding.

The reference builds jitted, sharded steps with abstract inputs for AOT
compilation; PyTorch runs eagerly, so the port's :class:`BuiltStep` holds a
plain callable and the tokens it consumes per call.  The prefill and serve
step builders and the pipeline builders come with later slices (ROADMAP
Queue 1).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from ..models import model as M
from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_update, warmup_cosine
from ..timing import timed

__all__ = ["BuiltStep", "make_train_step"]


@dataclass
class BuiltStep:
    #: ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    fn: Callable[..., Any]
    #: tokens consumed per invocation — launchers feed this into the "tokens"
    #: counter channel (one counter_cell bump per executed step)
    tokens_per_call: int = 0


def _grads(cfg: ArchConfig, params, batch):
    """(grads in the params' dtypes, metrics) of ``M.loss_fn``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, metrics = M.loss_fn(cfg, live, batch)
    # a leaf the loss does not reach raises here rather than training on zeros
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return tree_map(lambda _: next(it), params), {k: v.detach() for k, v in metrics.items()}


# scope-aware decorator: nests under the caller's active scope (the
# STARTUP driver routine in launchers)
@timed("steps::make_train_step")
def make_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig,
    opt_cfg: AdamWConfig | None = None,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    accum_steps: int = 1,
) -> BuiltStep:
    """``accum_steps > 1``: microbatched gradient accumulation — the global
    batch is split into microbatches run one after another and their f32
    gradients averaged; activation memory scales down by the factor while
    FLOPs per token are unchanged.  The learning rate is ``warmup_cosine`` of
    the optimizer state's ``step``."""
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig()
    if accum_steps < 1 or shape.global_batch % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the global batch "
                         f"{shape.global_batch}")

    def train_step(params, opt_state, batch):
        lr = warmup_cosine(
            opt_state["step"], peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
        if accum_steps > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            per_micro = []
            for micro in range(accum_steps):
                mb = {k: v.chunk(accum_steps, dim=0)[micro] for k, v in batch.items()}
                g, m = _grads(cfg, params, mb)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.float() / accum_steps)
                per_micro.append(m)
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]}
        else:
            grads, metrics = _grads(cfg, params, batch)
        params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state, lr)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return BuiltStep(fn=train_step, tokens_per_call=shape.global_batch * shape.seq_len)
