"""The program's span log, read by the per-layer metrics over its spans.

The one module of the benchmark that reads ``repro_torch.timing.span_log``:
the timer windows the program logged while the traced run's profiler
recorded (path, parent, host start and end on ``time.perf_counter_ns``).
Those host times are on the clock that
``trace.Tracer`` aligns the device operations to, so a window and the
device's idle gaps (``trace.idle_gaps``) compare directly.  Every reader
here gives None without a trace, and without a span log or the counter it
reads (a program that does not record them).
"""

from __future__ import annotations

import heapq

from .trace import idle_gaps

__all__ = ["span_log", "device_ms_per_step", "idle_under_s", "idle_inside_s"]


def span_log(lo_ns: int, hi_ns: int) -> list | None:
    """The program's logged windows that overlap [lo_ns, hi_ns], or None
    where the program keeps no span log."""
    try:
        from repro_torch.timing import span_log as read
    except ImportError:
        return None
    return read(lo_ns, hi_ns)


def device_ms_per_step(ctx, path: str) -> float | None:
    """Milliseconds a training step of the device time the program's timer
    ``path`` gained in the traced window (its counter ``<path>/device_s``:
    CUDA events at each window's start and stop)."""
    if ctx.trace is None:
        return None
    seconds = ctx.counters.get(f"{path}/device_s")
    if seconds is None:
        return None
    return 1e3 * seconds / ctx.values["steps"]


def _under(path: str, prefix: str) -> bool:
    return path == prefix or path.startswith(prefix + "/")


def _gaps(trace) -> list[tuple[int, int]]:
    return idle_gaps([(s, e) for _, s, e in trace.ops], trace.lo, trace.hi)


def idle_under_s(ctx, prefix: str) -> float | None:
    """Seconds of the traced window's device idle gaps whose start falls while
    the innermost open window is ``prefix`` or a path below it.  The
    innermost window at an instant is, of the windows open then on any
    thread, the one that started last: on one thread the deepest, across
    threads the one entered most recently (a remat recompute on autograd's
    thread, not the main thread's window that waits for the backward).  None
    where the log holds no window at or below ``prefix``."""
    if ctx.trace is None:
        return None
    trace = ctx.trace
    spans = span_log(trace.lo, trace.hi)
    if spans is None:
        return None
    if not any(_under(e.path, prefix) for e in spans):
        return None
    order = sorted(spans, key=lambda e: e.start_ns)
    open_: list[tuple[int, int, str]] = []  # (-start, end, path): latest start on top
    at, total = 0, 0
    for s, e in _gaps(trace):
        while at < len(order) and order[at].start_ns <= s:
            w = order[at]
            heapq.heappush(open_, (-w.start_ns, w.end_ns, w.path))
            at += 1
        while open_ and open_[0][1] <= s:  # ended before this gap: never open again
            heapq.heappop(open_)
        if open_ and _under(open_[0][2], prefix):
            total += e - s
    return total / 1e9


def idle_inside_s(ctx, path: str) -> tuple[float, int] | None:
    """(seconds of the traced window's device idle gaps inside the windows of
    the timer ``path``, the number of those windows in the traced window)."""
    if ctx.trace is None:
        return None
    trace = ctx.trace
    spans = span_log(trace.lo, trace.hi)
    if spans is None:
        return None
    windows: list[list[int]] = []
    for w in sorted((e for e in spans if e.path == path), key=lambda e: e.start_ns):
        s, e = max(w.start_ns, trace.lo), min(w.end_ns, trace.hi)
        if windows and s <= windows[-1][1]:  # overlapping windows count once
            windows[-1][1] = max(windows[-1][1], e)
        else:
            windows.append([s, e])
    n = sum(1 for e in spans if e.path == path)
    total, i = 0, 0
    for s, e in _gaps(trace):
        while i < len(windows) and windows[i][1] <= s:
            i += 1
        j = i
        while j < len(windows) and windows[j][0] < e:
            total += max(0, min(e, windows[j][1]) - max(s, windows[j][0]))
            j += 1
    return total / 1e9, n
