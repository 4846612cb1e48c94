"""Attention forward's share of its roofline in the window's prefills: the
least time their causal attention needs over the device time of the
operations ``ops/attn_fwd/`` names, in percent."""


def read(ctx):
    flops, bytes_ = ctx.values["attn_fwd"]
    return ctx.roofline("attn_fwd", flops, bytes_)
