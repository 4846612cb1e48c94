"""The traced run's device trace and host samples, and their reduction.

``Tracer.start`` starts ``torch.profiler`` (device activity only), puts one
marker operation on the idle device to align the profiler's clock with the
host's, and starts a thread that samples what the main thread is running
(its innermost frame in the program or the benchmark) every two milliseconds.
``Tracer.stop`` ends both.  ``Trace`` then holds the device operations of
the window, read from the profiler's raw events (building ``key_averages()``
took tens of seconds for a serving window), and reduces them:

* ``busy_s``: the union of the operations' intervals inside the window (two
  streams' overlapping operations count once);
* ``op_seconds(patterns)``: summed durations of the operations whose name
  matches one of the regular expressions;
* ``breakdown()``: the ten operations that took most time and the idle
  stretches grouped by what the host was doing, ten largest.
"""

from __future__ import annotations

import bisect
import re
import sys
import threading
import time
from collections import Counter, defaultdict

__all__ = ["Trace", "Tracer", "union_seconds", "idle_gaps"]


def union_seconds(intervals: list[tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of [lo, hi] (ns) that the union of the (start, end) ns intervals covers."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def idle_gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def _label(frame) -> str:
    """The innermost frame of the program or the benchmark, as file:function."""
    while frame is not None:
        name = frame.f_code.co_filename
        for root in ("repro_torch", "portbench"):
            at = name.rfind(f"/{root}/")
            if at >= 0:
                return f"{name[at + 1:]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "other"


class _Sampler(threading.Thread):
    def __init__(self, target_ident: int, period_s: float = 2e-3) -> None:
        super().__init__(daemon=True)
        self.target, self.period = target_ident, period_s
        self.samples: list[tuple[int, str]] = []
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            frame = sys._current_frames().get(self.target)
            self.samples.append((time.perf_counter_ns(), _label(frame)))
            time.sleep(self.period)

    def finish(self) -> None:
        self._halt.set()
        self.join()


class Trace:
    """Device operations (name, start, end in host ns) of one window."""

    def __init__(self, ops: list[tuple[str, int, int]], lo: int, hi: int,
                 samples: list[tuple[int, str]]) -> None:
        self.ops, self.lo, self.hi, self.samples = ops, lo, hi, samples

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.ops], self.lo, self.hi)

    def op_seconds(self, patterns: list[str]) -> float:
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for name, s, e in self.ops if any(r.search(name) for r in rx)) / 1e9

    def breakdown(self) -> dict:
        by_name: dict[str, int] = defaultdict(int)
        for name, s, e in self.ops:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        times = [t for t, _ in self.samples]
        idle: dict[str, int] = defaultdict(int)
        for s, e in idle_gaps([(s, e) for _, s, e in self.ops], self.lo, self.hi):
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            seen = Counter(label for _, label in self.samples[i:j])
            if not seen and i > 0:  # no sample inside: the one just before
                seen = Counter([self.samples[i - 1][1]])
            idle[seen.most_common(1)[0][0] if seen else "unsampled"] += e - s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], t / 1e9] for n, t in top],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}


class Tracer:
    """Starts and stops the profiler and the host sampler around a window."""

    def __init__(self) -> None:
        self.prof = None
        self.sampler = None
        self.lo = self.hi = 0

    def start(self) -> int:
        """Start tracing on an idle device; returns the window's start (host ns)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self._host_marker = time.perf_counter_ns()
        marker.add_(1.0)
        torch.cuda.synchronize()
        self.sampler = _Sampler(threading.main_thread().ident)
        self.sampler.start()
        self.lo = time.perf_counter_ns()
        return self.lo

    def stop(self) -> int:
        """Stop tracing (the caller has waited for the device); returns the end."""
        self.hi = time.perf_counter_ns()
        self.sampler.finish()
        self.prof.stop()
        return self.hi

    def trace(self) -> Trace:
        """Read the finished window's device operations (host clock)."""
        from torch.autograd import DeviceType

        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            raw.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        raw.sort(key=lambda r: r[1])
        # the first operation is the marker, launched on an idle device just
        # after _host_marker: its start aligns the two clocks
        offset = raw[0][1] - self._host_marker if raw else 0
        ops = [(n, s - offset, e - offset) for n, s, e in raw[1:]]
        return Trace(ops, self.lo, self.hi, list(self.sampler.samples))
