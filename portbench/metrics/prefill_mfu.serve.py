"""The prefill's share of the chip's peak: the benchmark's model FLOPs of the
window's prefills (``work.prefill_flops``) over the seconds the port timer
``serve/prefill`` (which ends in a device synchronise) gained in the window
times the bf16 peak, in percent."""

from portbench.work import PEAK_BF16_FLOPS


def read(ctx):
    seconds = ctx.spans.get("serve/prefill", (0.0, 0.0))[0]
    if seconds <= 0.0:
        return None
    return 100.0 * ctx.values["prefill_flops"] / (seconds * PEAK_BF16_FLOPS)
