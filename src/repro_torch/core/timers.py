"""Timers — caliper points around code regions (paper Sec. 2, Table 3).

A :class:`Timer` encapsulates one instance of **every registered clock**; querying
a timer returns the readings of all its clocks.  Timers live in a process-global
:class:`TimerDB` ("the internal timer database") addressed either by integer
handle — the Cactus C API style (``CCTK_TimerCreate`` → handle,
``CCTK_TimerStartI(handle)``) — or by name.  A thread-local running stack gives
hierarchical attribution (self time vs. child time) without explicit nesting
annotations.

Hot-path architecture (paper: "a high performance interface"):

* A timer does **not** hold a dict of clock objects on the fast path.  It holds
  two flat float arrays — accumulated totals and window marks — laid out by the
  process-wide :class:`~repro.core.clocks.ChannelLayout` for the current clock
  registry version.  ``start`` is one fused sampling pass into the marks array;
  ``stop`` is a second pass plus an element-wise diff into the accumulators.
* Clocks without a fused sampler (user :class:`~repro.core.clocks.CallbackClock`
  with arming hooks, exotic subclasses) keep the classic per-timer ``Clock``
  object path and are started/stopped around the fused pass.
* Clock instantiation is lazy: creating a timer allocates nothing clock-related;
  the layout is resolved on first start/read and re-resolved only when the
  registry version changes, so a clock registered mid-run appears on existing
  timers from their next window (the paper's extensibility guarantee).
* ``TimerDB.start/stop`` take a handle-indexed fast path — no name resolution
  and no database RLock for already-created timers; ``create`` and name lookups
  keep the locked slow path.
* ``Timer.clocks`` remains available as the compatibility view: fused clocks
  are exposed as array-backed proxy objects supporting the full Cactus clock
  API (``read/get/set/reset/start/stop``) over the timer's flat storage.

Flattened views namespace colliding channel names as ``<clock>.<channel>``
(two clocks exporting the same channel no longer silently overwrite each
other).

The supported call-path-facing surface lives one layer up in
:mod:`repro.timing`: hierarchical scopes (:meth:`TimerDB.scope` /
:meth:`TimerDB.scope_handle`) derive path-addressed timers from the running
stack, and :meth:`TimerDB.tree` aggregates the recorded per-parent attribution
into an inclusive/exclusive forest.  (The earlier flat sugar — ``TimerDB.timing``
and a module-level ``timed`` — finished its deprecation window and was
removed; use :func:`repro.timing.scope` / :func:`repro.timing.timed`.)
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from collections.abc import Iterator, Mapping
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

from . import clocks as _clocks
from .clocks import _REGISTRY_VERSION as _VERSION  # atomic int read; hot path

__all__ = [
    "PARENT_STATS_CAP",
    "SPAN_LOG_CAP",
    "ScopeHandle",
    "SpanEntry",
    "Timer",
    "TimerDB",
    "TimerNode",
    "path_matches",
    "reset_timer_db",
    "span_log",
    "timer_db",
]

#: Per-timer bound on distinct parent-chain attribution buckets.  A timer
#: entered under ever-changing enclosing scopes (an unbounded set of call
#: paths — usually a scope name interpolated with a request or step id) would
#: otherwise grow ``_parent_stats`` without limit over a long run.  At the cap
#: the least-recently-windowed chain is evicted (its seconds stay in the
#: timer's accumulators; only the per-chain split is dropped) and the timer's
#: ``parent_stats_evictions`` counter is bumped — exported as
#: ``repro_timing_parent_stats_evictions_total`` so a soak can alert on it.
PARENT_STATS_CAP = 128

#: Entries the span log keeps; past it the oldest entry goes and the counter
#: channel ``spans_dropped`` counts it.
SPAN_LOG_CAP = 1 << 16


class SpanEntry(NamedTuple):
    """One recorded timer window: host times on ``time.perf_counter_ns``."""

    path: str
    parent: str | None
    start_ns: int
    end_ns: int


# The span log: process-global, like the counter cells, so it outlives the
# session whose windows it holds.  Windows are recorded only while a
# torch.profiler session records (torch's own flag, read through sys.modules
# so that a process without torch never imports it): each such window appends
# one SpanEntry at its stop and, where CUDA is initialised, times a pair of
# device events (core.clocks.device_event_start/stop) into the channel
# "<timer path>/device_s".
_SPAN_LOG: deque[SpanEntry] = deque(maxlen=SPAN_LOG_CAP)
_MODULES = sys.modules


def span_log(lo_ns: int, hi_ns: int) -> list[SpanEntry]:
    """The logged windows that overlap [lo_ns, hi_ns] (``perf_counter_ns``),
    in the order they stopped."""
    return [e for e in list(_SPAN_LOG) if e.end_ns >= lo_ns and e.start_ns <= hi_ns]


def _open_span() -> tuple:
    event = _clocks.device_event_start()
    return time.perf_counter_ns(), event


def _close_span(timer: Timer, span: tuple) -> None:
    end_ns = time.perf_counter_ns()
    start_ns, event = span
    if event is not None:
        _clocks.device_event_stop(f"{timer.name}/device_s", event)
    if len(_SPAN_LOG) == _SPAN_LOG.maxlen:
        _clocks.increment_counter("spans_dropped", 1.0)
    _SPAN_LOG.append(SpanEntry(timer.name, timer.parent_name, start_ns, end_ns))


def path_matches(name: str, prefix: str) -> bool:
    """Whole-path-segment prefix match over ``/``-separated timer paths.

    ``"serve"`` matches ``"serve"`` and ``"serve/admit"`` but *not*
    ``"server_x"`` (the classic ``startswith`` false positive).  A trailing
    ``/`` on the prefix restricts the match to strict descendants.
    """
    if not prefix:
        return True
    if name == prefix:
        return True
    sep = prefix if prefix.endswith("/") else prefix + "/"
    return name.startswith(sep)


class TimerError(RuntimeError):
    pass


class _FusedClockView:
    """Cactus clock API over one fused clock's slice of a timer's flat arrays.

    ``read``/``get``/``set``/``reset`` operate on the timer's accumulators for
    this clock's channels; ``start``/``stop`` open an independent accumulation
    window (marks local to the view) for code driving a single clock directly.

    Views resolve their channel indices against the timer's *current* layout
    on every use (cold path), so a view held across a mid-run clock
    registration keeps working; channels no longer present resolve to ``None``
    and read 0.0.  Layout sync itself only ever happens between windows.
    """

    __slots__ = ("name", "units", "_timer", "_channels", "_vmarks",
                 "_cached_layout", "_cached_indices")

    def __init__(self, timer: Timer, name: str, channels, units) -> None:
        self.name = name
        self.units = dict(units)
        self._timer = timer
        self._channels = tuple(channels)
        self._vmarks: dict[str, float] | None = None
        self._cached_layout: _clocks.ChannelLayout | None = None
        self._cached_indices: tuple = ()

    # -- helpers (timer lock held) --------------------------------------------
    def _indices_locked(self) -> tuple:
        layout = self._timer._layout
        if layout is not self._cached_layout:
            get = layout.key_index.get
            self._cached_indices = tuple(get((self.name, ch)) for ch in self._channels)
            self._cached_layout = layout
        return self._cached_indices

    def _current_locked(self) -> list[float]:
        """Channel values incl. live timer window; timer lock held."""
        timer = self._timer
        accum = timer._accum
        indices = self._indices_locked()
        vals = [accum[i] if i is not None else 0.0 for i in indices]
        live = timer._layout.sample() if (timer.running or self._vmarks) else None
        if timer.running:
            marks = timer._marks
            vals = [
                v + live[i] - marks[i] if i is not None else v
                for v, i in zip(vals, indices)
            ]
        if self._vmarks is not None:
            vmarks = self._vmarks
            vals = [
                v + live[i] - vmarks[ch] if i is not None and ch in vmarks else v
                for v, i, ch in zip(vals, indices, self._channels)
            ]
        return vals

    # -- Cactus clock API ----------------------------------------------------
    def read(self) -> _clocks.ClockValues:
        with self._timer._lock:
            if not self._timer.running:
                self._timer._sync_layout_locked()
            vals = self._current_locked()
        return _clocks.ClockValues(
            values=dict(zip(self._channels, vals)), units=dict(self.units)
        )

    def get(self) -> dict[str, float]:
        return self.read().values

    def set(self, values: Mapping[str, float]) -> None:
        timer = self._timer
        with timer._lock:
            if not timer.running:
                timer._sync_layout_locked()
            indices = self._indices_locked()
            accum = timer._accum
            for i, ch in zip(indices, self._channels):
                if i is not None:
                    accum[i] = float(values.get(ch, 0.0))
            if timer.running or self._vmarks is not None:
                live = timer._layout.sample()
                if timer.running:
                    for i in indices:
                        if i is not None:
                            timer._marks[i] = live[i]
                if self._vmarks is not None:
                    self._vmarks = {
                        ch: live[i]
                        for ch, i in zip(self._channels, indices)
                        if i is not None
                    }

    def reset(self) -> None:
        self.set({})

    def start(self) -> None:
        timer = self._timer
        with timer._lock:
            if self._vmarks is not None:
                return
            if not timer.running:  # never re-layout under an open window
                timer._sync_layout_locked()
            live = timer._layout.sample()
            self._vmarks = {
                ch: live[i]
                for ch, i in zip(self._channels, self._indices_locked())
                if i is not None
            }

    def stop(self) -> None:
        timer = self._timer
        with timer._lock:
            if self._vmarks is None:
                return
            live = timer._layout.sample()
            accum = timer._accum
            vmarks = self._vmarks
            for ch, i in zip(self._channels, self._indices_locked()):
                if i is not None and ch in vmarks:
                    accum[i] += live[i] - vmarks[ch]
            self._vmarks = None

    def destroy(self) -> None:
        with self._timer._lock:
            self._vmarks = None

    @property
    def is_running(self) -> bool:
        return self._vmarks is not None


class Timer:
    """A named caliper point.  Not usually constructed directly — use
    :meth:`TimerDB.create` so the timer is registered in the database."""

    __slots__ = (
        "name",
        "handle",
        "count",
        "running",
        "parent_name",
        "_lock",
        "_layout",
        "_accum",
        "_marks",
        "_nonfused",
        "_views",
        "_parent_path",
        "_parent_stats",
        "parent_stats_evictions",
        "_span",
    )

    def __init__(self, name: str, handle: int) -> None:
        self.name = name
        self.handle = handle
        self.count = 0  # number of completed start/stop windows
        self.running = False
        self.parent_name: str | None = None
        self._lock = threading.Lock()
        # lazy: resolved on first start/read, re-resolved on registry bumps
        self._layout: _clocks.ChannelLayout | None = None
        self._accum: list[float] = []
        self._marks: list[float] = []
        self._nonfused: dict[str, _clocks.Clock] = {}
        self._views: dict[str, object] | None = None
        # per-call-path window attribution: {ancestor path tuple: [wall_s,
        # count, last-window tick]} — a timer entered under several enclosing
        # scopes (a shared library routine, the final checkpoint in SHUTDOWN)
        # splits exactly in tree(), including its own sub-scopes.  Bounded to
        # PARENT_STATS_CAP chains per timer (LRU by last-window tick).
        self._parent_path: tuple[str, ...] = ()
        self._parent_stats: dict[tuple[str, ...], list] = {}
        self.parent_stats_evictions = 0
        self._span: tuple | None = None  # the open window's record (_open_span)

    # -- layout management (lock held) ----------------------------------------
    def _sync_layout_locked(self) -> None:
        """Adopt the current registry layout, carrying accumulated values over
        by (clock, channel) key.  Must not be called mid-window."""
        layout = self._layout
        if layout is not None and layout.version == _VERSION[0]:
            return
        new = _clocks.channel_layout()
        if new is layout:
            return
        accum = [0.0] * new.n_fused
        if layout is not None:
            old_accum = self._accum
            get = new.key_index.get
            for i, key in enumerate(layout.fused_keys):
                j = get(key)
                if j is not None:
                    accum[j] = old_accum[i]
        nonfused: dict[str, _clocks.Clock] = {}
        for name in new.nonfused_names:
            clock = self._nonfused.get(name)
            nonfused[name] = clock if clock is not None else _clocks.make_clock(name)
        self._layout = new
        self._accum = accum
        self._nonfused = nonfused
        self._views = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self.running:
                raise TimerError(f"timer {self.name!r} already running")
            layout = self._layout
            if layout is None or layout.version != _VERSION[0]:
                self._sync_layout_locked()
                layout = self._layout
            # sample before flipping state: a sampler exception must not leave
            # the timer stuck "running" with stale marks
            marks = layout.sample()
            if self._nonfused:
                started = []
                try:
                    for clock in self._nonfused.values():
                        clock.start()
                        started.append(clock)
                except BaseException:
                    # unwind: a failed arming hook must not leave earlier
                    # clocks mid-window (their next start would no-op)
                    for clock in started:
                        clock.stop()
                    raise
            self._marks = marks
            self.running = True
            # the span recorder: one flag check a window while nothing profiles
            prof = _MODULES.get("torch.autograd.profiler")
            if prof is not None and prof._is_profiler_enabled:
                self._span = _open_span()

    def stop(self) -> None:
        with self._lock:
            if not self.running:
                raise TimerError(f"timer {self.name!r} is not running")
            # stop non-fused clocks first: their on_stop hooks can raise, and
            # a retried stop() must not re-apply the fused diff (Clock.stop
            # no-ops when already stopped, so the retry is safe either way)
            if self._nonfused:
                for clock in self._nonfused.values():
                    clock.stop()
            now = self._layout.sample()
            marks = self._marks
            self._accum = [
                a + v - m for a, v, m in zip(self._accum, now, marks)
            ]
            self.running = False
            self.count += 1
            # per-call-path attribution (one dict update per window): the
            # wall seconds of this window land in the bucket of the full
            # enclosing-scope chain recorded at start
            wi = self._layout.walltime_index
            stats = self._parent_stats
            entry = stats.get(self._parent_path)
            if entry is None:
                if len(stats) >= PARENT_STATS_CAP:
                    # evict the least-recently-windowed chain (O(cap), paid
                    # only on an at-cap insert); the evicted seconds remain in
                    # the timer's accumulators — only the per-chain split goes
                    oldest = min(stats, key=lambda p: stats[p][2])
                    del stats[oldest]
                    self.parent_stats_evictions += 1
                stats[self._parent_path] = [
                    now[wi] - marks[wi] if wi is not None else 0.0, 1, self.count
                ]
            else:
                if wi is not None:
                    entry[0] += now[wi] - marks[wi]
                entry[1] += 1
                entry[2] = self.count
            span = self._span
            if span is not None:
                self._span = None
                _close_span(self, span)

    def reset(self) -> None:
        with self._lock:
            if self._layout is not None:
                self._accum = [0.0] * self._layout.n_fused
                if self.running:
                    self._marks = self._layout.sample()
            for clock in self._nonfused.values():
                clock.reset()
            self.count = 0
            self._parent_stats = {}
            self.parent_stats_evictions = 0

    # -- queries ---------------------------------------------------------------
    def _values_locked(self) -> list[float]:
        vals = list(self._accum)
        if self.running:
            now = self._layout.sample()
            marks = self._marks
            vals = [a + n - m for a, n, m in zip(vals, now, marks)]
        return vals

    def read(self) -> dict[str, _clocks.ClockValues]:
        """Readings for all clocks (running timers report up-to-now values)."""
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            layout = self._layout
            vals = self._values_locked()
            out: dict[str, _clocks.ClockValues] = {}
            for name, sl, channels, units in layout.clock_meta:
                out[name] = _clocks.ClockValues(
                    values=dict(zip(channels, vals[sl])), units=dict(units)
                )
            for name, clock in self._nonfused.items():
                out[name] = clock.read()
        return out

    def read_flat(self) -> dict[str, float]:
        """Flattened {channel: value} view across all clocks.

        Channel names colliding across clocks come back namespaced as
        ``<clock>.<channel>`` (every colliding export is renamed, so no clock's
        reading silently overwrites another's).
        """
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            layout = self._layout
            flat = dict(zip(layout.fused_flat, self._values_locked()))
            for name, clock in self._nonfused.items():
                mapping = layout.nonfused_flat.get(name, {})
                for ch, v in clock.read().values.items():
                    flat[mapping.get(ch, ch)] = v
        return flat

    def seconds(self) -> float:
        """Accumulated wall seconds (the most common query)."""
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            layout = self._layout
            idx = layout.walltime_index
            if idx is None:
                clock = self._nonfused.get("walltime")
                return clock.read().scalar() if clock is not None else 0.0
            if not self.running:
                return self._accum[idx]
            now = self._layout.sample()
            return self._accum[idx] + now[idx] - self._marks[idx]

    def channel(self, name: str) -> float:
        """One flat channel's current value (0.0 when absent) — the cheap
        single-metric read used by cross-process reducers."""
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            idx = self._layout.flat_index.get(name)
            if idx is not None:
                if not self.running:
                    return self._accum[idx]
                now = self._layout.sample()
                return self._accum[idx] + now[idx] - self._marks[idx]
        return self.read_flat().get(name, 0.0)

    def set_channel(self, name: str, value: float) -> None:
        """Directly set one flat channel's accumulated value (Cactus
        ``CCTK_TimerSet`` analogue; used by reducers publishing remote
        measurements into the database)."""
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            idx = self._layout.flat_index.get(name)
            if idx is None:
                # plain name that got collision-namespaced: the canonical
                # export is the clock named like its channel (e.g. walltime),
                # mirroring the read-side fallback in seconds()
                idx = self._layout.key_index.get((name, name))
            if idx is None:
                for clock_name, clock in self._nonfused.items():
                    mapping = self._layout.nonfused_flat.get(clock_name, {})
                    for ch, flat in mapping.items():
                        if flat == name:
                            values = dict(clock.read().values)
                            values[ch] = float(value)
                            clock.set(values)
                            return
                raise TimerError(
                    f"timer {self.name!r} has no channel {name!r}"
                )
            self._accum[idx] = float(value)
            if self.running:
                now = self._layout.sample()
                self._marks[idx] = now[idx]

    def parent_stats(self, live: bool = False) -> dict[tuple[str, ...], tuple[float, int]]:
        """Window attribution per enclosing call path:
        ``{ancestor scope chain (() for top level): (wall seconds, windows)}``.

        ``live=True`` folds a currently open window's elapsed wall seconds
        into its chain's bucket (window count unchanged) — what tree views on
        a live monitor need so a still-running ancestor keeps its subtree.
        """
        with self._lock:
            out = {p: (e[0], e[1]) for p, e in self._parent_stats.items()}
            if live and self.running:
                wi = self._layout.walltime_index
                if wi is not None:
                    delta = self._layout.sample()[wi] - self._marks[wi]
                    s, c = out.get(self._parent_path, (0.0, 0))
                    out[self._parent_path] = (s + delta, c)
        return out

    @property
    def clocks(self) -> dict[str, object]:
        """Compatibility view: {clock name: clock object}.  Fused clocks are
        array-backed proxies over this timer's flat storage; slow-path clocks
        are the real per-timer ``Clock`` instances."""
        with self._lock:
            if not self.running:
                self._sync_layout_locked()
            if self._views is None:
                layout = self._layout
                views: dict[str, object] = {}
                for name, _sl, channels, units in layout.clock_meta:
                    views[name] = _FusedClockView(self, name, channels, units)
                views.update(self._nonfused)
                self._views = views
            return self._views


class ScopeHandle:
    """A pre-resolved hierarchical scope — the hot-path form of the scope API.

    Holds the :class:`Timer` for one absolute path, resolved **once** at
    construction (``timing.scope_handle("train/step")``); entering/exiting the
    handle is the fused start/stop window plus the thread-local stack
    push/pop — no dict lookups, no name resolution, no database lock.  Parent
    attribution is still dynamic: every enter re-derives ``parent_name`` from
    the current thread's running stack, so a handle entered under different
    enclosing scopes reports under whichever parent was active.

    Handles are cached per database by :meth:`TimerDB.scope_handle`.  Like
    the underlying timer, a handle admits one open window at a time: a second
    enter — same thread or another — raises ``TimerError`` without touching
    the running window's attribution.  Threads timing the same region
    concurrently should use per-thread paths (cf. the concurrency tests).
    """

    __slots__ = ("path", "timer", "_tls")

    def __init__(self, db: TimerDB, path: str) -> None:
        self.path = path
        self.timer = db.get(db.create(path))
        self._tls = db._tls

    def __enter__(self) -> Timer:
        timer = self.timer
        tls = self._tls
        try:
            stack = tls.stack
        except AttributeError:
            stack = tls.stack = []
        # start first: a failed start (double enter) must not corrupt the
        # open window's recorded attribution
        timer.start()
        timer.parent_name = stack[-1] if stack else None
        timer._parent_path = tuple(stack)
        stack.append(timer.name)
        return timer

    def __exit__(self, exc_type, exc, tb) -> None:
        self.timer.stop()
        stack = self._tls.stack
        if stack:
            name = self.timer.name
            if stack[-1] == name:  # common LIFO case
                stack.pop()
            else:  # overlapping windows: drop the most recent occurrence
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] == name:
                        del stack[i]
                        break

    def seconds(self) -> float:
        return self.timer.seconds()

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"ScopeHandle({self.path!r})"


@dataclass
class TimerNode:
    """One node of the parent/child timer forest built by :meth:`TimerDB.tree`.

    ``inclusive`` is the timer's accumulated wall seconds; ``exclusive`` is
    self time — inclusive minus the sum of the children's inclusive seconds
    (unclamped, so the arithmetic identity is exact; real nestings keep it
    non-negative because child windows sit inside parent windows on one
    monotonic clock).
    """

    name: str
    count: int
    inclusive: float
    exclusive: float
    children: list[TimerNode] = field(default_factory=list)

    @property
    def depth(self) -> int:
        """Height of this subtree (a leaf has depth 1)."""
        return 1 + max((c.depth for c in self.children), default=0)

    def walk(self) -> Iterator[tuple[int, TimerNode]]:
        """Depth-first ``(level, node)`` traversal of this subtree."""
        todo: list[tuple[int, TimerNode]] = [(0, self)]
        while todo:
            level, node = todo.pop()
            yield level, node
            todo.extend((level + 1, c) for c in reversed(node.children))


class TimerDB:
    """The queryable timer database.  Any routine can obtain timing statistics
    for any other routine by querying this database (paper Sec. 2).

    ``start``/``stop`` by integer handle bypass the database lock entirely:
    the timer list is append-only, so an index read is safe under the GIL.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._timers: list[Timer] = []
        self._by_name: dict[str, int] = {}
        self._tls = threading.local()
        self._scope_handles: dict[str, ScopeHandle] = {}

    # -- creation / lookup -----------------------------------------------------
    def create(self, name: str, exist_ok: bool = True) -> int:
        """Create (or look up) a timer; returns its integer handle."""
        with self._lock:
            if name in self._by_name:
                if not exist_ok:
                    raise TimerError(f"timer {name!r} already exists")
                return self._by_name[name]
            handle = len(self._timers)
            timer = Timer(name, handle)
            self._timers.append(timer)
            self._by_name[name] = handle
            return handle

    def get(self, ref: int | str) -> Timer:
        with self._lock:
            if isinstance(ref, str):
                if ref not in self._by_name:
                    raise TimerError(f"no timer named {ref!r}")
                ref = self._by_name[ref]
            if not 0 <= ref < len(self._timers):
                raise TimerError(f"invalid timer handle {ref}")
            return self._timers[ref]

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._by_name

    def names(self) -> list[str]:
        with self._lock:
            return [t.name for t in self._timers]

    def timers(self) -> list[Timer]:
        with self._lock:
            return list(self._timers)

    # -- running stack (hierarchy) ----------------------------------------------
    def _stack(self) -> list[str]:
        try:
            return self._tls.stack
        except AttributeError:
            stack: list[str] = []
            self._tls.stack = stack
            return stack

    def start(self, ref: int | str) -> None:
        timers = self._timers
        if type(ref) is int and 0 <= ref < len(timers):
            timer = timers[ref]  # fast path: append-only list, no lock
        else:
            timer = self.get(ref)
        try:
            stack = self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
        timer.start()  # before attribution: a double start must not corrupt it
        timer.parent_name = stack[-1] if stack else None
        timer._parent_path = tuple(stack)
        stack.append(timer.name)

    def stop(self, ref: int | str) -> None:
        timers = self._timers
        if type(ref) is int and 0 <= ref < len(timers):
            timer = timers[ref]
        else:
            timer = self.get(ref)
        timer.stop()
        try:
            stack = self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
        if stack:
            if stack[-1] == timer.name:  # common LIFO case
                stack.pop()
                return
            # Tolerate out-of-order stops (paper allows overlapping measurement
            # windows); remove the most recent occurrence.
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == timer.name:
                    del stack[i]
                    break

    def reset(self, ref: int | str) -> None:
        self.get(ref).reset()

    def reset_all(self) -> None:
        for timer in self.timers():
            timer.reset()

    def read(self, ref: int | str) -> dict[str, _clocks.ClockValues]:
        return self.get(ref).read()

    # -- queries -------------------------------------------------------------
    def snapshot(self) -> dict[str, dict[str, float]]:
        """{timer name: flattened channel readings + count} for all timers."""
        out: dict[str, dict[str, float]] = {}
        for timer in self.timers():
            flat = timer.read_flat()
            flat["count"] = float(timer.count)
            out[timer.name] = flat
        return out

    def total_seconds(self, prefix: str = "") -> float:
        """Summed wall seconds over timers whose path equals ``prefix`` or
        lives under it (whole-segment match: ``"serve"`` does not pick up a
        ``server_x`` timer).  Note that summing a parent scope together with
        its children counts nested time more than once — for self-vs-children
        breakdowns use :meth:`tree`."""
        return sum(
            t.seconds() for t in self.timers() if path_matches(t.name, prefix)
        )

    # -- hierarchy --------------------------------------------------------------
    def scope_handle(self, path: str) -> ScopeHandle:
        """The cached :class:`ScopeHandle` for an absolute timer path.

        Resolution (name → timer object) happens here, once; the returned
        handle's enter/exit is the lock-free fused fast path.  This is the
        primary API for hot loops::

            h = db.scope_handle("train/step")
            ...
            with h:          # zero dict lookups
                step()
        """
        handle = self._scope_handles.get(path)
        if handle is None:
            with self._lock:
                handle = self._scope_handles.get(path)
                if handle is None:
                    handle = ScopeHandle(self, path)
                    self._scope_handles[path] = handle
        return handle

    @contextmanager
    def scope(self, name: str) -> Iterator[Timer]:
        """Open a hierarchical scope: the timer's path is ``name`` nested
        under the enclosing scope on this thread's running stack, so

            with db.scope("step"):
                with db.scope("forward"): ...

        records timers ``step`` and ``step/forward`` with parent/child
        attribution derived from runtime nesting (no annotations).  ``name``
        may itself contain ``/`` segments.  Pre-resolve hot paths with
        :meth:`scope_handle` instead (absolute path, no per-entry joining).
        """
        try:
            stack = self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
        path = f"{stack[-1]}/{name}" if stack else name
        handle = self._by_name.get(path)
        if handle is None:
            handle = self.create(path)
        timer = self._timers[handle]
        timer.start()  # before attribution: a double start must not corrupt it
        timer.parent_name = stack[-1] if stack else None
        timer._parent_path = tuple(stack)
        stack.append(path)
        try:
            yield timer
        finally:
            timer.stop()
            if stack:
                if stack[-1] == path:
                    stack.pop()
                else:
                    for i in range(len(stack) - 1, -1, -1):
                        if stack[i] == path:
                            del stack[i]
                            break

    def current_scope(self) -> str:
        """This thread's innermost running scope path (``""`` outside any)."""
        try:
            stack = self._tls.stack
        except AttributeError:
            return ""
        return stack[-1] if stack else ""

    def tree(self) -> list[TimerNode]:
        """The parent/child forest over all timers, from recorded call-path
        attribution (SPACE-Timers-style tree view).

        Every completed (or live) window was recorded under the full chain of
        enclosing scopes active at its start, so the forest is an exact call
        tree: a timer entered under *several* enclosing chains (a shared
        helper, the final checkpoint write in SHUTDOWN) splits into one node
        per chain, each carrying exactly the wall seconds and window count
        accrued there — including its own sub-scopes, which land under the
        matching split.  For properly nested windows this guarantees
        ``sum(child.inclusive) <= parent.inclusive`` on every node
        (overlapping/out-of-order windows, which the paper permits, are
        attributed best-effort by the stack state at start).  A node whose
        recorded chain has no corresponding parent node (root-level timers,
        hand-set attribution, never-started rows) roots its own tree.
        ``exclusive`` is inclusive minus the direct children's inclusive.
        """
        timers = self.timers()
        nodes: dict[tuple[str, ...], TimerNode] = {}  # full chain -> node
        singles: list[tuple[Timer, tuple[str, ...] | None]] = []
        for t in timers:
            buckets = t.parent_stats(live=True)
            if len(buckets) <= 1:
                # single- or never-windowed timer (incl. set_channel-published
                # rows): one node whose inclusive is the live seconds()
                # reading, so set()/reset() adjustments stay authoritative
                singles.append((t, next(iter(buckets), None)))
                continue
            for chain, (seconds, count) in buckets.items():
                nodes[chain + (t.name,)] = TimerNode(
                    name=t.name, count=count, inclusive=seconds, exclusive=0.0
                )
        for t, chain in singles:
            if chain is None:
                chain = (t.parent_name,) if t.parent_name else ()
            key = chain + (t.name,)
            if key not in nodes:  # split timers keep their exact buckets
                nodes[key] = TimerNode(
                    name=t.name, count=t.count, inclusive=t.seconds(), exclusive=0.0
                )
        roots: list[TimerNode] = []
        for key, node in nodes.items():
            parent = nodes.get(key[:-1]) if len(key) > 1 else None
            if parent is None or parent is node:
                roots.append(node)
            else:
                parent.children.append(node)
        for node in nodes.values():
            node.exclusive = node.inclusive - sum(c.inclusive for c in node.children)
        return roots

    # -- boundedness introspection ------------------------------------------------
    def cardinality(self) -> dict[str, int]:
        """Size of every internal store that must stay bounded on a long run:
        ``{"timers", "scope_handles", "parent_stats_buckets",
        "parent_stats_buckets_max", "parent_stats_evictions"}``.

        This is the hook the metrics exporter and the soak gate read — a
        control loop (or user code) that allocates a new timer or attribution
        bucket per step shows up here as monotonic growth long before it OOMs.
        Counter-store cardinality lives in
        :func:`repro.core.clocks.counter_stats`.
        """
        timers = self.timers()
        buckets = [len(t._parent_stats) for t in timers]
        return {
            "timers": len(timers),
            "scope_handles": len(self._scope_handles),
            "parent_stats_buckets": sum(buckets),
            "parent_stats_buckets_max": max(buckets, default=0),
            "parent_stats_evictions": sum(
                t.parent_stats_evictions for t in timers
            ),
        }


_DB = TimerDB()


def timer_db() -> TimerDB:
    """The process-global timer database (the active
    :class:`repro.timing.TimingSession`'s database while one is entered)."""
    return _DB


def reset_timer_db() -> TimerDB:
    """Replace the global DB (tests).  Prefer ``with repro.timing.session():``
    for new code — it scopes the swap and restores the previous database."""
    global _DB
    _DB = TimerDB()
    return _DB


def _install_db(db: TimerDB) -> TimerDB:
    """Swap the process-global database, returning the previous one.

    Internal wiring for :class:`repro.timing.TimingSession`; everything that
    defaults to :func:`timer_db` (scopes, reports, detectors, monitors) picks
    up the session database for the session's lifetime.
    """
    global _DB
    prev, _DB = _DB, db
    return prev
