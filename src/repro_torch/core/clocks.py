"""Clocks — the low-level measurement entities of the timing infrastructure.

Faithful to the paper (Sec. 2, Tables 1-2): a *clock* is an object created from a
set of callbacks (``create/destroy/start/stop/read/reset/get/set``) that measures
"any kind of event" — wall time, CPU time, cycle counters, or discrete events such
as I/O bytes or FLOPs executed.  Clocks are registered with the infrastructure via
a standard registration mechanism so new metrics require *no modification to any
existing timing code*: every :class:`~repro.core.timers.Timer` automatically
encapsulates one instance of every registered clock.

Hardware adaptation: PyTorch returns before the card finishes, so a host clock
around asynchronous work measures its enqueue.  The port's device clock is a
pair of CUDA timing events recorded on the current stream at a timer window's
start and stop (:func:`device_event_start` / :func:`device_event_stop`); the
pair is read back without a synchronise of its own, at the program's own
synchronisation points (:func:`resolve_device_events`), and adds its elapsed
seconds to the counter channel ``<timer path>/device_s``.  The timers record
the pair (and a span, ``core.timers.span_log``) only while a
``torch.profiler`` session records; otherwise a window pays one flag check.
The remaining PAPI-analogue channels are :class:`CounterClock` channels for
framework events (model FLOPs of executed steps, checkpoint bytes, collective
bytes, tokens processed); ``xla_flops`` / ``xla_bytes`` keep their names only
for parity with the reference's reports.

Performance architecture (paper: "a high performance interface"):

* **Fused sampling.**  Built-in clocks implement :meth:`Clock.fused_sampler`,
  returning a closure that reads the clock's raw channel values as a flat
  sequence of floats.  :func:`channel_layout` composes every fused sampler of
  the current registry into one :class:`ChannelLayout` whose ``sample()`` fills
  a flat float array in a single pass — a timer start/stop window is two such
  passes plus an element-wise diff, with no per-clock dicts or locks.  The
  layout is stamped with the registry version and cached process-wide, so all
  timers share one resolved layout per registry generation.
* **Slow-path compatibility.**  Clocks without a fused sampler (e.g. a user
  :class:`CallbackClock` with ``on_start``/``on_stop`` arming hooks) keep the
  classic per-timer ``Clock`` object path.  New clocks must either implement
  fused sampling or accept the slow-path cost.
* **Lock-free counters.**  :func:`increment_counter` appends to a per-channel
  pending list (``list.append`` is an atomic C operation under the GIL), and
  readers fold pending amounts into a base total under a read-side lock.
  Hot loops should resolve a channel once with :func:`counter_cell` and call
  the returned cell directly — that is a single C-level call per increment.
"""

from __future__ import annotations

import os
import threading
import time
from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass


__all__ = [
    "Clock",
    "ClockValues",
    "CallbackClock",
    "WalltimeClock",
    "CPUTimeClock",
    "PerfCounterClock",
    "ThreadCPUClock",
    "RSSClock",
    "CounterClock",
    "ChannelLayout",
    "channel_layout",
    "register_clock",
    "unregister_clock",
    "clock_names",
    "registry_version",
    "make_clock",
    "make_all_clocks",
    "counter_cell",
    "counter_channel",
    "counter_names",
    "counter_stats",
    "counter_values",
    "increment_counter",
    "fold_pending_counters",
    "reset_default_clocks",
    "device_event_start",
    "device_event_stop",
    "resolve_device_events",
]


@dataclass
class ClockValues:
    """A multi-valued clock reading (a clock can measure several values at once,
    e.g. multiple PAPI counters)."""

    values: dict[str, float]
    units: dict[str, str]

    def __getitem__(self, key: str) -> float:
        return self.values[key]

    def scalar(self) -> float:
        """The clock's primary value (first channel)."""
        return next(iter(self.values.values())) if self.values else 0.0


class Clock:
    """Base clock.  Subclasses implement ``_now() -> dict`` returning the current
    raw counter values; accumulation across start/stop windows is handled here so
    that a clock can be started and stopped many times, with ``read`` returning
    the accumulated measure (Cactus semantics: reset sets accumulation to zero).
    """

    #: registry name; subclasses override.
    name: str = "abstract"
    #: units per channel.
    units: Mapping[str, str] = {}

    def __init__(self) -> None:
        self._running = False
        self._accum: dict[str, float] = {}
        self._mark: dict[str, float] = {}

    # -- core sampling hook -------------------------------------------------
    def _now(self) -> dict[str, float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def fused_sampler(self) -> Callable[[], Sequence[float]] | None:
        """Zero-arg closure returning this clock's raw channel values (ordered
        as ``units``) as a flat float sequence, for the fused timer hot path.

        Return ``None`` (the default) for clocks that need per-window object
        state or arming hooks; such clocks take the per-timer slow path.
        """
        return None

    # -- Cactus clock API ----------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._mark = self._now()

    def stop(self) -> None:
        if not self._running:
            return
        now = self._now()
        for key, value in now.items():
            self._accum[key] = self._accum.get(key, 0.0) + (value - self._mark.get(key, 0.0))
        self._running = False

    def reset(self) -> None:
        self._accum = {}
        if self._running:
            self._mark = self._now()

    def read(self) -> ClockValues:
        values = dict(self._accum)
        if self._running:
            now = self._now()
            for key, value in now.items():
                values[key] = values.get(key, 0.0) + (value - self._mark.get(key, 0.0))
        for key in self._channels():
            values.setdefault(key, 0.0)
        return ClockValues(values=values, units=dict(self.units))

    # Cactus `get`/`set`: direct access to the accumulator.
    def get(self) -> dict[str, float]:
        return self.read().values

    def set(self, values: Mapping[str, float]) -> None:
        self._accum = dict(values)
        if self._running:
            self._mark = self._now()

    def destroy(self) -> None:
        self._running = False
        self._accum = {}

    @property
    def is_running(self) -> bool:
        return self._running

    def _channels(self) -> Sequence[str]:
        return tuple(self.units.keys())


class CallbackClock(Clock):
    """A clock built from user callbacks — the paper's extension mechanism.

    ``sample`` returns the raw counter values; optional ``on_start``/``on_stop``
    callbacks allow clocks that must arm hardware counters.  Callback clocks
    keep the classic per-timer object path (no fused sampler) so their arming
    hooks fire once per window, exactly as before.
    """

    def __init__(
        self,
        name: str,
        sample: Callable[[], Mapping[str, float]],
        units: Mapping[str, str],
        on_start: Callable[[], None] | None = None,
        on_stop: Callable[[], None] | None = None,
    ) -> None:
        self.name = name
        self.units = dict(units)
        self._sample = sample
        self._on_start = on_start
        self._on_stop = on_stop
        super().__init__()

    def _now(self) -> dict[str, float]:
        return dict(self._sample())

    def start(self) -> None:
        if not self._running and self._on_start is not None:
            self._on_start()
        super().start()

    def stop(self) -> None:
        if self._running and self._on_stop is not None:
            self._on_stop()
        super().stop()


class WalltimeClock(Clock):
    """UNIX wall time (the paper's ``gettimeofday``), via a monotonic source."""

    name = "walltime"
    units = {"walltime": "sec"}

    def _now(self) -> dict[str, float]:
        return {"walltime": time.monotonic()}

    def fused_sampler(self):
        return _scalar_sampler(time.monotonic)


# ---------------------------------------------------------------------------
# Process CPU time: on most kernels ``time.process_time`` is a ~100ns vDSO
# read, but on syscall-trapping kernels (gVisor and similar) it is a slow
# trap (several microseconds).  The fused hot path therefore reads it through
# a process-wide cache that is refreshed at most once per ``refresh_ns`` —
# calibrated at import: exact (refresh 0) when the source is cheap, ~1 ms
# granularity when it is not.  Totals telescope across windows (marks always
# come from the same monotone cache), so long-run accumulation stays exact to
# within one refresh interval; sub-interval windows see quantized CPU time.
# Override with REPRO_CPUTIME_REFRESH_US (microseconds; 0 forces exact reads).
# ---------------------------------------------------------------------------

def _perf_counter_float() -> float:
    return float(time.perf_counter_ns())


def _scalar_sampler(fn: Callable[[], float]) -> Callable[[], tuple[float]]:
    """Wrap a single-value raw reader for the fused path.  Tagged with
    ``scalar_fn`` so the layout code can merge runs of adjacent
    single-channel clocks into one closure (fewer calls and allocations)."""

    def sample() -> tuple[float]:
        return (fn(),)

    sample.scalar_fn = fn  # type: ignore[attr-defined]
    return sample


_CPUTIME_CACHE = [0.0, -(10 ** 18)]  # [value_sec, perf_ns at last refresh]
_CPUTIME_REFRESH_LOCK = threading.Lock()


def _calibrate_cputime_refresh_ns() -> int:
    env = os.environ.get("REPRO_CPUTIME_REFRESH_US", "auto")
    if env != "auto":
        try:
            return max(int(float(env) * 1000.0), 0)
        except ValueError:
            return 0
    probe = time.process_time
    perf = time.perf_counter_ns
    # min of individual probes: one scheduler hiccup during calibration must
    # not misclassify a cheap vDSO source as a trapping syscall
    best = float("inf")
    for _ in range(8):
        t0 = perf()
        probe()
        best = min(best, perf() - t0)
    # Cheap vDSO source: sample exactly. Trapping source: 1 ms granularity.
    return 1_000_000 if best > 2_000 else 0


_CPUTIME_REFRESH_NS = _calibrate_cputime_refresh_ns()


def _refresh_cputime_cache(now_ns: int) -> float:
    """Serialized refresh: concurrent refreshers must never write the cache
    backwards (a torn older value would yield negative window deltas)."""
    cache = _CPUTIME_CACHE
    with _CPUTIME_REFRESH_LOCK:
        if now_ns - cache[1] >= _CPUTIME_REFRESH_NS:  # still stale once inside
            value = time.process_time()
            cache[:] = (value, time.perf_counter_ns())
    return cache[0]


def _cputime_cached() -> float:
    now_ns = time.perf_counter_ns()
    cache = _CPUTIME_CACHE
    if now_ns - cache[1] >= _CPUTIME_REFRESH_NS:
        return _refresh_cputime_cache(now_ns)
    return cache[0]


class CPUTimeClock(Clock):
    """Process CPU time (the paper's ``getrusage``: user+system seconds).

    The direct object path (``_now``) always reads the exact source; the fused
    timer path samples through the rate-limited cache described above.
    """

    name = "cputime"
    units = {"cputime": "sec"}

    def _now(self) -> dict[str, float]:
        return {"cputime": time.process_time()}

    def fused_sampler(self):
        if _CPUTIME_REFRESH_NS <= 0:
            # exact mode (cheap vDSO source): read directly, no cache, no lock
            return _scalar_sampler(time.process_time)
        return _scalar_sampler(_cputime_cached)


class ThreadCPUClock(Clock):
    """Per-thread CPU time — useful to separate the main thread from async
    checkpoint writers."""

    name = "thread_cputime"
    units = {"thread_cputime": "sec"}

    def _now(self) -> dict[str, float]:
        return {"thread_cputime": time.thread_time()}

    def fused_sampler(self):
        return _scalar_sampler(time.thread_time)


class PerfCounterClock(Clock):
    """Highest-resolution counter available (the paper's ``rdtsc`` analogue).

    Reported in nanoseconds; resolution is typically ~20ns on Linux.
    """

    name = "perfcounter"
    units = {"perfcounter": "nsec"}

    def _now(self) -> dict[str, float]:
        return {"perfcounter": float(time.perf_counter_ns())}

    def fused_sampler(self):
        return _scalar_sampler(_perf_counter_float)


class RSSClock(Clock):
    """Resident-set-size high-water delta, read from /proc (Linux).

    Demonstrates a non-time clock per the paper ("clocks are not restricted to
    measure time").  Value is the change in VmRSS over the window, in bytes.
    """

    name = "rss"
    units = {"rss": "bytes"}

    _PAGE = 4096

    def _now(self) -> dict[str, float]:
        try:
            with open("/proc/self/statm") as f:
                parts = f.read().split()
            return {"rss": float(int(parts[1]) * self._PAGE)}
        except (OSError, IndexError, ValueError):  # pragma: no cover
            return {"rss": 0.0}

    def fused_sampler(self):
        now = self._now
        return _scalar_sampler(lambda: now()["rss"])


# ---------------------------------------------------------------------------
# Counter channels: process-global monotonically increasing event counters that
# framework code bumps (checkpoint bytes written, tokens processed, FLOPs of
# executed steps, ...).  A CounterClock snapshots a channel at start/stop, so a
# timer window captures exactly the events that happened inside it.  This is
# the TPU-era stand-in for PAPI event counters.
#
# Storage: one cell per channel, holding a folded ``base`` total plus a
# ``pending`` list of raw amounts.  Writers only ever ``pending.append(x)`` —
# an atomic C-level operation, safe from any thread without a lock.  Readers
# fold ``pending[:n]`` into ``base`` and delete the folded prefix under
# _COUNTER_READ_LOCK; concurrent appends land past the folded prefix and are
# never lost.
#
# Write-only channels (written but never exported through a registered
# CounterClock) have no reader to fold them, so their pending lists are capped:
# ``increment_counter`` self-folds its channel when pending exceeds
# _PENDING_FOLD_CAP (amortized: one locked fold per CAP appends), and the
# fused counter samplers — which already hold the read lock every timer
# window — sweep *all* cells every _PENDING_SWEEP_EVERY passes, folding any
# overflowing cell (this catches raw ``counter_cell`` handles, whose append is
# a bare C call that cannot check anything).  ``fold_pending_counters()`` is
# the explicit maintenance entry point for timer-less processes holding raw
# cells on never-read channels.
# ---------------------------------------------------------------------------

#: fold a channel's pending list once it holds this many unfolded amounts
_PENDING_FOLD_CAP = 4096
#: fused counter samplers sweep all cells for overflow every N sample passes
_PENDING_SWEEP_EVERY = 1024
_SWEEP_STATE = [0]


class _CounterCell:
    __slots__ = ("base", "pending")

    def __init__(self) -> None:
        self.base = 0.0
        self.pending: list[float] = []


_CELLS: dict[str, _CounterCell] = {}
_CELL_APPENDS: dict[str, Callable[[float], None]] = {}
_COUNTER_READ_LOCK = threading.Lock()
_CELLS_CREATE_LOCK = threading.Lock()


def _new_cell(name: str) -> _CounterCell:
    with _CELLS_CREATE_LOCK:
        cell = _CELLS.get(name)
        if cell is None:
            cell = _CounterCell()
            # publish the append before the cell so _CELL_APPENDS lookups in
            # increment_counter never see a cell without its fast path
            _CELL_APPENDS[name] = cell.pending.append
            _CELLS[name] = cell
        return cell


def counter_cell(name: str) -> Callable[[float], None]:
    """Resolve a channel once; returns the lock-free increment callable.

    The returned cell is ``list.append`` bound to the channel's pending list —
    a single C-level call per increment, safe from any thread.  This is the
    recommended hot-loop API (the counter analogue of timer handles)::

        bump = counter_cell("xla_flops")
        ...
        bump(flops_this_step)   # ~50ns, no lock
    """
    cell = _CELL_APPENDS.get(name)
    if cell is None:
        _new_cell(name)
        cell = _CELL_APPENDS[name]
    return cell


def increment_counter(name: str, amount: float) -> None:
    """Add ``amount`` to channel ``name`` (lock-free fast path).

    Name-resolved per call; hot loops should use :func:`counter_cell`.
    ``amount + 0.0`` both coerces ints to float and raises ``TypeError`` here,
    at the call site, for non-numeric input (never poisoning the channel).
    Self-folds the channel when its pending list hits the overflow cap, so a
    write-only channel cannot grow without bound.
    """
    try:
        append = _CELL_APPENDS[name]
    except KeyError:
        _new_cell(name).pending.append(float(amount))
        return
    try:
        append(amount + 0.0)
    except TypeError:
        append(float(amount))  # e.g. numeric strings
    # bound write-only channels: the bound append's __self__ IS the pending
    # list, so the overflow probe costs one attribute read + len
    pending = append.__self__
    if len(pending) >= _PENDING_FOLD_CAP:
        with _COUNTER_READ_LOCK:
            _fold_cell_locked(_CELLS[name])


def fold_pending_counters() -> None:
    """Fold every channel's pending amounts into its base total now.

    Maintenance entry point for processes that hold raw :func:`counter_cell`
    handles on channels no registered clock ever reads *and* never run a
    timer window (which would sweep them): call this periodically to keep
    those pending lists bounded.  Totals are unchanged.
    """
    with _COUNTER_READ_LOCK:
        for cell in list(_CELLS.values()):
            _fold_cell_locked(cell)


def _sweep_overflow_locked() -> None:
    """Fold any cell whose pending list overflowed; read lock held."""
    for cell in list(_CELLS.values()):
        if len(cell.pending) >= _PENDING_FOLD_CAP:
            _fold_cell_locked(cell)


def _fold_cells_into(append: Callable[[float], None], cells) -> None:
    """Fold each cell's pending amounts into its base total and emit the
    totals via ``append``.  Caller holds the read lock.

    This is the single fold implementation shared by the name-based readers
    and every fused sampler, so the semantics below hold everywhere:
    ``len``/slice-copy/``del prefix`` are each atomic; concurrent appends go
    past index ``n`` and survive the prefix delete, so no update is lost.
    Non-numeric values (possible only through a raw :func:`counter_cell`
    handle, which skips call-site validation) are dropped rather than left to
    poison every later read of the channel.
    """
    for cell in cells:
        pending = cell.pending
        n = len(pending)
        if n:
            chunk = pending[:n]
            del pending[:n]
            try:
                cell.base += float(sum(chunk))
            except TypeError:
                cell.base += float(
                    sum(x for x in chunk if isinstance(x, (int, float)))
                )
        append(cell.base)


def _fold_cell_locked(cell: _CounterCell) -> float:
    """One cell's folded total; caller holds the read lock."""
    out: list[float] = []
    _fold_cells_into(out.append, (cell,))
    return out[0]


def counter_channel(name: str) -> float:
    with _COUNTER_READ_LOCK:
        cell = _CELLS.get(name)
        return _fold_cell_locked(cell) if cell is not None else 0.0


def counter_values(names: Sequence[str]) -> list[float]:
    """Merged totals for several channels in one read-lock acquisition."""
    with _COUNTER_READ_LOCK:
        cells = _CELLS
        out = []
        for name in names:
            cell = cells.get(name)
            out.append(_fold_cell_locked(cell) if cell is not None else 0.0)
        return out


def counter_names() -> list[str]:
    """Every counter channel created so far, sorted — the enumeration hook
    exporters use (channels are created on first write and never deleted)."""
    with _CELLS_CREATE_LOCK:
        return sorted(_CELLS)


def counter_stats() -> dict[str, int]:
    """Boundedness introspection over the counter store:
    ``{"channels", "pending_total", "pending_max"}``.

    ``pending_*`` count *unfolded* amounts — by design each channel's pending
    list stays under ``_PENDING_FOLD_CAP`` (readers fold, writers self-fold at
    the cap, fused samplers sweep), so a pending total that keeps climbing
    means some path defeats all three folds.  The metrics exporter publishes
    these and the soak gate asserts they stay flat; the timer-side counterpart
    is :meth:`repro.core.timers.TimerDB.cardinality`.
    """
    with _COUNTER_READ_LOCK:
        pending = [len(cell.pending) for cell in _CELLS.values()]
    return {
        "channels": len(pending),
        "pending_total": sum(pending),
        "pending_max": max(pending, default=0),
    }


def _make_counter_sampler(names: tuple[str, ...]) -> Callable[[], list[float]]:
    """Fused sampler over counter channels: one read-lock acquisition, folds
    inlined, cells resolved once at layout build (cells are never deleted).
    Tagged with ``counter_names`` so the layout code can merge adjacent
    counter clocks into a single lock acquisition per sample pass."""
    lock = _COUNTER_READ_LOCK
    cells = tuple(_new_cell(name) for name in names)
    fold = _fold_cells_into
    sweep_state = _SWEEP_STATE

    def sample() -> list[float]:
        out: list[float] = []
        with lock:
            fold(out.append, cells)
            tick = sweep_state[0] + 1
            if tick >= _PENDING_SWEEP_EVERY:
                sweep_state[0] = 0
                _sweep_overflow_locked()
            else:
                sweep_state[0] = tick
        return out

    sample.counter_names = names  # type: ignore[attr-defined]
    return sample


class CounterClock(Clock):
    """Clock over one or more global counter channels."""

    def __init__(self, name: str, channels: Mapping[str, str]) -> None:
        self.name = name
        self.units = dict(channels)
        super().__init__()

    def _now(self) -> dict[str, float]:
        names = tuple(self.units)
        return dict(zip(names, counter_values(names)))

    def fused_sampler(self):
        return _make_counter_sampler(tuple(self.units))


# ---------------------------------------------------------------------------
# Device clock: CUDA-event seconds of timer windows.  A recorded window holds
# a pair of timing events from its device's pool; a stopped pair waits in
# _DEVICE_PENDING until resolve_device_events finds both events complete (a
# non-blocking ``query``), then adds ``elapsed_time`` to the window's
# ``device_s`` channel and returns the events to that pool.  torch is imported only here, by a
# recording window: a process that never profiles never loads it for this.
# ---------------------------------------------------------------------------

#: resolve on a stop once this many pairs wait (a program with no
#: synchronisation point of its own still folds what the card has finished)
_DEVICE_RESOLVE_AT = 4096

#: free events by device index (an event is bound to the device it first
#: recorded on)
_EVENT_POOLS: dict[int, list] = {}
_DEVICE_PENDING: list[tuple[str, int, object, object]] = []
_DEVICE_LOCK = threading.Lock()
#: stream objects by (device index, raw stream handle), since the default
#: stream's handle is 0 on every device: ``torch.cuda.current_stream()``
#: builds a new object each call, most of a record's host cost (~13 µs
#: against ~6 µs on an H100 host under the profiler)
_STREAMS: dict[tuple[int, int], object] = {}


def _cuda_ready() -> bool:
    import torch

    return torch.cuda.is_initialized()


def _new_device_event():
    import torch

    return torch.cuda.Event(enable_timing=True)


def _current_device() -> int:
    import torch

    return torch._C._cuda_getDevice()


def _current_stream(device: int):
    """The calling thread's current CUDA stream on ``device``."""
    import torch

    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(device)
    return stream


def _pooled_event(device: int):
    try:
        return _EVENT_POOLS[device].pop()
    except (KeyError, IndexError):
        return _new_device_event()


def device_event_start():
    """(device index, a pooled timing event recorded now on its current
    stream), or None in a process that has not initialised CUDA (a CPU-only
    run)."""
    if not _cuda_ready():
        return None
    device = _current_device()
    event = _pooled_event(device)
    event.record(_current_stream(device))
    return device, event


def device_event_stop(channel: str, start) -> None:
    """Record the pair's end event now, on the start's device, and leave the
    pair to :func:`resolve_device_events`, which adds its seconds to
    ``channel``."""
    device, begin = start
    end = _pooled_event(device)
    end.record(_current_stream(device))
    with _DEVICE_LOCK:
        _DEVICE_PENDING.append((channel, device, begin, end))
        due = len(_DEVICE_PENDING) >= _DEVICE_RESOLVE_AT
    if due:
        resolve_device_events()


def resolve_device_events() -> int:
    """Fold every pair whose two events have completed into its channel;
    pairs still in flight wait for the next call.  Never waits for the
    device.  Returns the number of pairs folded."""
    if not _DEVICE_PENDING:
        return 0
    folded = 0
    with _DEVICE_LOCK:
        waiting = []
        for pair in _DEVICE_PENDING:
            channel, device, start, end = pair
            if end.query() and start.query():
                increment_counter(channel, start.elapsed_time(end) / 1e3)
                _EVENT_POOLS.setdefault(device, []).extend((start, end))
                folded += 1
            else:
                waiting.append(pair)
        _DEVICE_PENDING[:] = waiting
    return folded


# ---------------------------------------------------------------------------
# Registry ("Cactus's standard registration techniques"): clock factories are
# registered by name; every Timer created afterwards instantiates all of them.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], Clock]] = {}
_REGISTRY_LOCK = threading.Lock()
_REGISTRY_VERSION = [0]


def register_clock(name: str, factory: Callable[[], Clock]) -> None:
    """Register a clock factory.  Registering an existing name replaces it
    (steerable at runtime, like Cactus parameters)."""
    with _REGISTRY_LOCK:
        _REGISTRY[name] = factory
        _REGISTRY_VERSION[0] += 1


def unregister_clock(name: str) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.pop(name, None)
        _REGISTRY_VERSION[0] += 1


def clock_names() -> list[str]:
    with _REGISTRY_LOCK:
        return sorted(_REGISTRY.keys())


def registry_version() -> int:
    # Lock-free: a single list-element read is atomic under the GIL, and the
    # version is monotone — the timer fast path polls this every window.
    return _REGISTRY_VERSION[0]


def make_clock(name: str) -> Clock:
    with _REGISTRY_LOCK:
        factory = _REGISTRY[name]
    return factory()


def make_all_clocks() -> dict[str, Clock]:
    with _REGISTRY_LOCK:
        factories = dict(_REGISTRY)
    return {name: factory() for name, factory in factories.items()}


# ---------------------------------------------------------------------------
# Channel layout: the resolved struct-of-arrays schema of the current registry.
# One flat float slot per channel of every fused clock, in registration order;
# clocks without a fused sampler are listed for the per-timer slow path.  Flat
# channel names are collision-namespaced: when two clocks export the same
# channel name, every colliding export is renamed ``<clock>.<channel>`` so no
# reading silently overwrites another in flattened views.
# ---------------------------------------------------------------------------


class ChannelLayout:
    """Immutable resolved layout for one registry version (shared by all
    timers; rebuild is triggered by a version-stamp mismatch)."""

    __slots__ = (
        "version",
        "sample",
        "n_fused",
        "fused_keys",
        "fused_flat",
        "key_index",
        "flat_index",
        "clock_meta",
        "nonfused_names",
        "nonfused_flat",
        "walltime_index",
    )

    def __init__(
        self,
        version: int,
        samplers: list[Callable[[], Sequence[float]]],
        fused_keys: list[tuple[str, str]],
        fused_flat: list[str],
        clock_meta: list[tuple[str, slice, tuple[str, ...], dict[str, str]]],
        nonfused_names: list[str],
        nonfused_flat: dict[str, dict[str, str]],
    ) -> None:
        self.version = version
        self.n_fused = len(fused_keys)
        self.fused_keys = tuple(fused_keys)
        self.fused_flat = tuple(fused_flat)
        self.key_index = {key: i for i, key in enumerate(fused_keys)}
        self.flat_index = {name: i for i, name in enumerate(fused_flat)}
        self.clock_meta = tuple(clock_meta)
        self.nonfused_names = tuple(nonfused_names)
        self.nonfused_flat = nonfused_flat
        self.walltime_index = self.key_index.get(("walltime", "walltime"))
        if self.walltime_index is None:
            self.walltime_index = self.flat_index.get("walltime")
        fns = tuple(samplers)

        if (
            len(fns) == 2
            and getattr(fns[0], "time3", False)
            and getattr(fns[1], "counter_names", None) is not None
        ):
            # the default registry shape: collapse to one closure, zero
            # composition overhead on the hot path
            fns = (
                _make_default_sampler(
                    fns[1].counter_names,
                    exact_cpu=getattr(fns[0], "exact_cpu", False),
                ),
            )

        if len(fns) == 0:

            def sample() -> list[float]:
                return []

        elif len(fns) == 1:
            single = fns[0]

            def sample() -> list[float]:
                return list(single())

        elif len(fns) == 2:
            first, second = fns

            def sample() -> list[float]:
                return [*first(), *second()]

        else:

            def sample() -> list[float]:
                out: list[float] = []
                for fn in fns:
                    out += fn()
                return out

        self.sample = sample


_LAYOUT_CACHE: dict[int, ChannelLayout] = {}


def channel_layout() -> ChannelLayout:
    """The resolved layout for the current registry version (cached)."""
    version = _REGISTRY_VERSION[0]
    cached = _LAYOUT_CACHE.get(version)
    if cached is not None:
        return cached
    with _REGISTRY_LOCK:
        version = _REGISTRY_VERSION[0]
        factories = list(_REGISTRY.items())
    layout = _build_layout(version, factories)
    if len(_LAYOUT_CACHE) > 8:  # keep the cache tiny; stale versions are dead
        _LAYOUT_CACHE.clear()
    _LAYOUT_CACHE[version] = layout
    return layout


def _time3_sampler(
    mono=time.monotonic,
    perf=time.perf_counter_ns,
    cache=_CPUTIME_CACHE,
) -> tuple[float, float, float]:
    """Hand-fused walltime/cputime/perfcounter pass for the default layout:
    one perf_counter read serves both the perfcounter channel and the cputime
    cache age check."""
    p = perf()
    if p - cache[1] >= _CPUTIME_REFRESH_NS:
        cpu = _refresh_cputime_cache(p)
    else:
        cpu = cache[0]
    return (mono(), cpu, float(p))


_time3_sampler.time3 = True  # type: ignore[attr-defined]


def _time3_exact_sampler(
    mono=time.monotonic,
    cpu=time.process_time,
    perf=time.perf_counter_ns,
) -> tuple[float, float, float]:
    """Exact-mode variant of :func:`_time3_sampler` for kernels where the
    CPU-time source is a cheap vDSO read: no cache, no lock."""
    return (mono(), cpu(), float(perf()))


_time3_exact_sampler.time3 = True  # type: ignore[attr-defined]
_time3_exact_sampler.exact_cpu = True  # type: ignore[attr-defined]


def _make_default_sampler(
    names: tuple[str, ...],
    exact_cpu: bool,
    mono=time.monotonic,
    perf=time.perf_counter_ns,
    cpu_read=time.process_time,
    cache=_CPUTIME_CACHE,
) -> Callable[[], list[float]]:
    """Fully fused single closure for the default registry shape
    (walltime/cputime/perfcounter followed by counter clocks): one call, one
    output list, no composition loop."""
    lock = _COUNTER_READ_LOCK
    cells = tuple(_new_cell(name) for name in names)
    fold = _fold_cells_into
    sweep_state = _SWEEP_STATE

    def sample() -> list[float]:
        p = perf()
        if exact_cpu:
            cpu = cpu_read()
        elif p - cache[1] >= _CPUTIME_REFRESH_NS:
            cpu = _refresh_cputime_cache(p)
        else:
            cpu = cache[0]
        out = [mono(), cpu, float(p)]
        with lock:
            fold(out.append, cells)
            tick = sweep_state[0] + 1
            if tick >= _PENDING_SWEEP_EVERY:
                sweep_state[0] = 0
                _sweep_overflow_locked()
            else:
                sweep_state[0] = tick
        return out

    return sample


def _merge_scalar_run(fns: list[Callable[[], float]]) -> Callable[[], Sequence[float]]:
    if fns == [time.monotonic, _cputime_cached, _perf_counter_float]:
        return _time3_sampler
    if fns == [time.monotonic, time.process_time, _perf_counter_float]:
        return _time3_exact_sampler
    n = len(fns)
    if n == 1:
        f = fns[0]
        return lambda: (f(),)
    if n == 2:
        f, g = fns
        return lambda: (f(), g())
    if n == 3:
        f, g, h = fns
        return lambda: (f(), g(), h())
    if n == 4:
        f, g, h, k = fns
        return lambda: (f(), g(), h(), k())
    frozen = tuple(fns)
    return lambda: [fn() for fn in frozen]


def _merge_samplers(
    samplers: list[Callable[[], Sequence[float]]],
) -> list[Callable[[], Sequence[float]]]:
    """Fuse runs of adjacent mergeable samplers.

    Channel slots of adjacent clocks are contiguous in the flat layout, so a
    merged sampler emits the concatenated values in place of the run: runs of
    counter clocks share one read-lock acquisition; runs of single-value raw
    readers (the built-in time clocks) share one closure call and one tuple.
    """
    merged: list[Callable[[], Sequence[float]]] = []
    counter_run: list[str] = []
    scalar_run: list[Callable[[], float]] = []

    def flush() -> None:
        if counter_run:
            merged.append(_make_counter_sampler(tuple(counter_run)))
            counter_run.clear()
        if scalar_run:
            merged.append(_merge_scalar_run(list(scalar_run)))
            scalar_run.clear()

    for sampler in samplers:
        names = getattr(sampler, "counter_names", None)
        scalar = getattr(sampler, "scalar_fn", None)
        if names is not None:
            if scalar_run:
                flush()
            counter_run.extend(names)
        elif scalar is not None:
            if counter_run:
                flush()
            scalar_run.append(scalar)
        else:
            flush()
            merged.append(sampler)
    flush()
    return merged


def _build_layout(
    version: int, factories: list[tuple[str, Callable[[], Clock]]]
) -> ChannelLayout:
    prototypes: list[tuple[str, Clock]] = [(name, factory()) for name, factory in factories]

    # collision detection across every clock's exported channels
    seen: dict[str, int] = {}
    for _, proto in prototypes:
        for ch in proto._channels():
            seen[ch] = seen.get(ch, 0) + 1

    def flat_name(clock_name: str, channel: str) -> str:
        return f"{clock_name}.{channel}" if seen.get(channel, 0) > 1 else channel

    samplers: list[Callable[[], Sequence[float]]] = []
    fused_keys: list[tuple[str, str]] = []
    fused_flat: list[str] = []
    clock_meta: list[tuple[str, slice, tuple[str, ...], dict[str, str]]] = []
    nonfused_names: list[str] = []
    nonfused_flat: dict[str, dict[str, str]] = {}

    for name, proto in prototypes:
        channels = tuple(proto._channels())
        sampler = proto.fused_sampler()
        if sampler is not None and channels:
            # one-time arity check: a mis-sized user sampler would silently
            # shift every later clock's values onto wrong channel slots
            probe = tuple(sampler())
            if len(probe) != len(channels):
                raise ValueError(
                    f"clock {name!r}: fused_sampler returned {len(probe)} "
                    f"values for {len(channels)} channels {channels}"
                )
        if sampler is None or not channels:
            nonfused_names.append(name)
            nonfused_flat[name] = {ch: flat_name(name, ch) for ch in channels}
            continue
        lo = len(fused_keys)
        samplers.append(sampler)
        for ch in channels:
            fused_keys.append((name, ch))
            fused_flat.append(flat_name(name, ch))
        clock_meta.append((name, slice(lo, len(fused_keys)), channels, dict(proto.units)))

    return ChannelLayout(
        version=version,
        samplers=_merge_samplers(samplers),
        fused_keys=fused_keys,
        fused_flat=fused_flat,
        clock_meta=clock_meta,
        nonfused_names=nonfused_names,
        nonfused_flat=nonfused_flat,
    )


def reset_default_clocks(extra: bool = False) -> None:
    """(Re-)install the built-in clock set.

    ``extra=True`` additionally installs the noisier clocks (rss, thread cpu).
    The device-event counters are always installed; they read 0 until the
    framework bumps their channels.
    """
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
        _REGISTRY_VERSION[0] += 1
    register_clock("walltime", WalltimeClock)
    register_clock("cputime", CPUTimeClock)
    register_clock("perfcounter", PerfCounterClock)
    register_clock(
        "xla_device",
        lambda: CounterClock(
            "xla_device", {"xla_flops": "flop", "xla_bytes": "bytes"}
        ),
    )
    register_clock(
        "io",
        lambda: CounterClock("io", {"io_bytes": "bytes", "io_ops": "count"}),
    )
    if extra:
        register_clock("rss", RSSClock)
        register_clock("thread_cputime", ThreadCPUClock)


# Install defaults at import time (cheap; tests may reinstall).
reset_default_clocks(extra=os.environ.get("REPRO_EXTRA_CLOCKS", "0") == "1")
