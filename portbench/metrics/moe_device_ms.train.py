"""The MoE layers' device milliseconds a training step: what the port timer
``model/moe`` (every call of the layer: the forward and, under remat, the
recompute) gained in its counter ``model/moe/device_s`` (CUDA events at each
window's start and stop, recorded while the traced run's profiler records)
over the window's steps.  The layer's backward runs outside those windows and
is not in this metric: its largest kernel, the gathers' backward
(``indexing_backward_kernel``), is counted in ``grads_device_ms.train``."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "model/moe")
