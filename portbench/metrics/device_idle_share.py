"""Percent of the traced window in which no device operation ran (the union
of the operations' intervals, so overlapping streams count once); the
reader of ``device_idle_share.train`` and ``device_idle_share.serve``."""


def read(ctx):
    return ctx.idle_share()
