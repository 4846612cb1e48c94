"""Device idle milliseconds a training step under the MoE layer: the traced
window's idle gaps (no device operation running) whose start falls while the
innermost open window of the program's span log is ``model/moe`` or a
window below it (``spans.idle_under_s``), over the window's steps: the time the
card waits for the host to launch the layer's work."""

from portbench.spans import idle_under_s


def read(ctx):
    seconds = idle_under_s(ctx, "model/moe")
    if seconds is None:
        return None
    return 1e3 * seconds / ctx.values["steps"]
