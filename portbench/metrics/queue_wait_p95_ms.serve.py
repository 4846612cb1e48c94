"""The 95th percentile over the window's answered requests of the wait from
when a request was due to when the engine admitted it (``RequestResult``'s
``admitted_at``): the serving engine's queue (``ServeSession``, its
``ADAPT/serving`` control)."""


def read(ctx):
    return ctx.values["queue_wait_p95_ms"]
