"""The whole training step's share of the chip's peak: the benchmark's model
FLOPs a step (``work.train_step_flops``: matmuls, head, attention; no
recompute) times the window's steps, over the window's seconds times the
bf16 peak, in percent."""

from portbench.work import PEAK_BF16_FLOPS


def read(ctx):
    v = ctx.values
    return 100.0 * v["flops_per_step"] * v["steps"] / (ctx.window_s * PEAK_BF16_FLOPS)
