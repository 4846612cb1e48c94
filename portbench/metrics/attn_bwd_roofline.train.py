"""Attention backward's share of its roofline in training: the least time the
window's attention backward needs (``work.attention_bwd``) over the device
time of the operations ``ops/attn_bwd/`` names, in percent."""


def read(ctx):
    flops, bytes_ = ctx.values["attn_bwd_per_step"]
    steps = ctx.values["steps"]
    return ctx.roofline("attn_bwd", flops * steps, bytes_ * steps)
