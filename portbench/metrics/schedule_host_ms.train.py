"""Host milliseconds a training step spends outside the step itself: the
window's wall time less what the port timer ``EVOL/trainer::train_step``
(which ends when the step's metrics are read back, so it holds the device's
time) gained in the window, over the timer's windows (steps) in it.  The
run_training schedule, its timers and its control loop (PRESTEP data,
ANALYSIS, CHECKPOINT, OUTPUT bins)."""


def read(ctx):
    seconds, steps = ctx.spans.get("EVOL/trainer::train_step", (0.0, 0.0))
    if steps <= 0:
        return None
    return 1e3 * (ctx.window_s - seconds) / steps
