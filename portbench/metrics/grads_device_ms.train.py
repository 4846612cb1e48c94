"""The gradients' device milliseconds a training step: what the port timer
``train_step/grads`` (forward, loss and backward: ``grads_of``) gained in its
counter ``train_step/grads/device_s`` (CUDA events at each window's start and
stop, recorded while the traced run's profiler records) over the window's
steps."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "train_step/grads")
