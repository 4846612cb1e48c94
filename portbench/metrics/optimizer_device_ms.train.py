"""The optimizer's device milliseconds a training step: what the port timer
``train_step/optimizer`` (``adamw_update``, the clip's global norm included)
gained in its counter ``train_step/optimizer/device_s`` (CUDA events at each
window's start and stop, recorded while the traced run's profiler records)
over the window's steps."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "train_step/optimizer")
