"""Session wiring — one object bundling the timing stack for a run.

:class:`TimingSession` owns a :class:`~repro.core.timers.TimerDB`, a
:class:`~repro.core.schedule.Scheduler` over it, and a
:class:`~repro.adapt.controller.ControlLoop` polling it (both built lazily),
plus the read side (flat report, tree report, forest).  Entering the session
installs its database as the process default, so every API that falls back to
:func:`repro.core.timers.timer_db` — scopes, counters, reports, straggler
detectors, monitors — records into the session for its lifetime; exiting
restores the previous database.  This replaces the
``timer_db()``/``reset_timer_db()`` global juggling tests and launchers used
to do by hand::

    with timing.session() as ts:
        with timing.scope("work"):
            ...
        print(ts.tree_report())

Sessions nest (the previous database is restored on exit) but are a
process-wide default, not thread-local: enter them from the driving thread.
"""

from __future__ import annotations

import threading

from ..core.clocks import CounterClock, channel_layout, clock_names, register_clock
from ..core.report import format_report, format_tree_report, tree_rows
from ..core.timers import ScopeHandle, Timer, TimerDB, TimerNode, _install_db
from .scopes import counter as _counter

__all__ = ["TimingSession", "current_session", "session"]

_ACTIVE: list[TimingSession] = []
_ACTIVE_LOCK = threading.Lock()

#: channels exported through the auto-registered session CounterClock.  The
#: map is process-global (counters themselves are process-global channels) and
#: additive: every scoped counter any session resolves becomes readable; the
#: clock is never auto-unregistered, because a layout rebuild drops
#: accumulated values for channels that vanish — reports formatted *after* a
#: session exits must still render its counters.
_SESSION_COUNTER_UNITS: dict[str, str] = {}
_SESSION_CLOCK_NAME = "session_counters"
_SESSION_CLOCK_LOCK = threading.Lock()


def export_counter_channel(channel: str, unit: str = "count") -> None:
    """Make ``channel`` readable by every timer window from now on.

    Scoped counters (``timing.counter("tokens")`` inside ``scope("serve")``)
    write to process-global channels that no built-in clock exports; without
    this, they are write-only — bumpable but invisible in reports.  The first
    resolution of each such channel re-registers the shared
    ``session_counters`` :class:`~repro.core.clocks.CounterClock` with the
    channel added (a registry version bump), so every timer picks it up from
    its next window and ``format_report(..., channels=("serve/tokens",))``
    renders it with zero manual clock setup.  A channel some other clock
    already exports is skipped — double-exporting would force the collision
    rename onto the established name.
    """
    with _SESSION_CLOCK_LOCK:
        if _SESSION_CLOCK_NAME not in clock_names():
            # a registry reset (e.g. test isolation) dropped the clock: the
            # channel cache is stale, rebuild from scratch
            _SESSION_COUNTER_UNITS.clear()
        elif channel in _SESSION_COUNTER_UNITS:
            return
        if channel_layout().flat_index.get(channel) is not None:
            # some other clock already exports this exact channel name;
            # double-exporting would force the collision rename on both
            return
        _SESSION_COUNTER_UNITS[channel] = unit
        units = dict(_SESSION_COUNTER_UNITS)
        # register inside the lock: two concurrent first-resolutions must not
        # let a stale (smaller) channel snapshot win the registration race
        register_clock(
            _SESSION_CLOCK_NAME, lambda: CounterClock(_SESSION_CLOCK_NAME, units)
        )


class TimingSession:
    """A self-contained timing stack: database + scheduler + control loop.

    Parameters
    ----------
    db:
        Timer database to bundle; a fresh one by default (pass
        ``timer_db()`` to wrap the current process default instead).
    scheduler / control_loop:
        Pre-built components to adopt; otherwise constructed lazily over
        ``db`` on first access (the control loop import is deferred so the
        facade stays import-light).
    """

    def __init__(
        self,
        db: TimerDB | None = None,
        *,
        scheduler=None,
        control_loop=None,
    ) -> None:
        self.db = db if db is not None else TimerDB()
        self._scheduler = scheduler
        self._control_loop = control_loop
        self._prev_dbs: list[TimerDB] = []

    # -- bundled components ----------------------------------------------------
    @property
    def scheduler(self):
        """The session's Cactus-bin scheduler (built over ``db`` on first use)."""
        if self._scheduler is None:
            from ..core.schedule import Scheduler

            self._scheduler = Scheduler(self.db)
        return self._scheduler

    @property
    def control_loop(self):
        """The session's runtime-adaptation loop (built over ``db`` on first
        use).  Register controllers on it and attach it to a schedule bin with
        ``session.scheduler.attach_control_loop(session.control_loop)``."""
        if self._control_loop is None:
            from ..adapt.controller import ControlLoop

            self._control_loop = ControlLoop(self.db)
        return self._control_loop

    # -- activation --------------------------------------------------------------
    def __enter__(self) -> TimingSession:
        self._prev_dbs.append(_install_db(self.db))
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _install_db(self._prev_dbs.pop())
        with _ACTIVE_LOCK:
            for i in range(len(_ACTIVE) - 1, -1, -1):
                if _ACTIVE[i] is self:
                    del _ACTIVE[i]
                    break

    # -- write-side sugar --------------------------------------------------------
    def scope(self, name: str):
        """Hierarchical scope on this session's database (see
        :func:`repro.timing.scope`)."""
        return self.db.scope(name)

    def scope_handle(self, path: str) -> ScopeHandle:
        """Pre-resolved absolute-path handle on this session's database."""
        return self.db.scope_handle(path)

    def counter(self, name: str, *, absolute: bool = False):
        """Scope-namespaced counter cell resolved against this session."""
        return _counter(name, absolute=absolute, db=self.db)

    def timer(self, ref: int | str) -> Timer:
        return self.db.get(ref)

    # -- read side ---------------------------------------------------------------
    def tree(self) -> list[TimerNode]:
        """The session's parent/child timer forest."""
        return self.db.tree()

    def total_seconds(self, prefix: str = "") -> float:
        """Segment-matched rollup over the session's timers."""
        return self.db.total_seconds(prefix)

    def report(self, **kwargs) -> str:
        """The flat Fig.-2 table (plus the ``ADAPT/`` decision log when the
        session's control loop has been used)."""
        kwargs.setdefault("adapt", self._control_loop)
        return format_report(self.db, **kwargs)

    def tree_report(self, **kwargs) -> str:
        """The hierarchical Fig.-2 table (inclusive/exclusive seconds)."""
        return format_tree_report(self.db, **kwargs)

    def tree_rows(self, prefix: str = "") -> list[dict[str, object]]:
        """Nested JSON-ready tree rows (the monitor's ``/tree`` payload)."""
        return tree_rows(self.db, prefix=prefix)

    def snapshot(self) -> dict[str, dict[str, float]]:
        return self.db.snapshot()


def session(db: TimerDB | None = None, **kwargs) -> TimingSession:
    """Build a :class:`TimingSession` (sugar mirroring ``with session():``)."""
    return TimingSession(db, **kwargs)


def current_session() -> TimingSession | None:
    """The innermost entered session, or ``None`` outside any."""
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None
