"""Attention forward's share of its roofline in training: the least time the
window's causal attention forward needs (counted once a step, though remat
"dots" runs the kernel again in the backward) over the device time of the
operations ``ops/attn_fwd/`` names, in percent."""


def read(ctx):
    flops, bytes_ = ctx.values["attn_fwd_per_step"]
    steps = ctx.values["steps"]
    return ctx.roofline("attn_fwd", flops * steps, bytes_ * steps)
