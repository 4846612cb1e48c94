"""Learning-rate schedules (pure functions of the step).

``step`` may be a Python number or a tensor (the optimizer state's int32
``step``); the result is an f32 tensor on the step's device, so a training
step reads its learning rate without a host round trip.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant_lr"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant_lr(step, *, peak_lr: float) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step).to(torch.float32), peak_lr)
