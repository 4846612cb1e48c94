"""Scheduler — Cactus-style schedule bins with automatic timers (paper Sec. 2).

Framework code is divided into modules ("thorns") that *schedule* routines into
named bins.  The scheduler controls execution order and is "a natural place to
put caliper points": every scheduled routine is wrapped in a timer named
``<BIN>/<thorn>::<routine>`` automatically, so any user or routine can obtain
timing statistics for any routine by querying the timer database — no explicit
instrumentation required.

Bins mirror the lifecycle of a training/serving run:

    STARTUP    — once, before the loop (mesh build, compile, restore)
    INITIAL    — once, after STARTUP (initial data / eval)
    PRESTEP    — every iteration, before the step (data fetch)
    EVOL       — every iteration: the jitted step itself
    ANALYSIS   — post-step analysis (eval, metrics); routines may be conditional
    CHECKPOINT — checkpoint decision + write (AdaptCheck lives here)
    OUTPUT     — reports, logs, monitoring
    SHUTDOWN   — once, after the loop (final checkpoint, final report)

Routines take a single :class:`RunState` argument and may mutate it.  Ordering
inside a bin respects ``before``/``after`` constraints (topological sort), like
Cactus schedule.ccl.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass, field
from typing import Any

from .timers import TimerDB, timer_db


__all__ = ["BINS", "RunState", "ScheduledRoutine", "Scheduler", "schedule_bin_timer_name"]

BINS = (
    "STARTUP",
    "INITIAL",
    "PRESTEP",
    "EVOL",
    "ANALYSIS",
    "CHECKPOINT",
    "OUTPUT",
    "SHUTDOWN",
)

_LOOP_BINS = ("PRESTEP", "EVOL", "ANALYSIS", "CHECKPOINT", "OUTPUT")


@dataclass
class RunState:
    """Mutable state threaded through scheduled routines."""

    iteration: int = 0
    max_iterations: int = 0
    should_terminate: bool = False
    # free-form slots for thorns (params, opt state, data iterator, ...)
    slots: dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:
        return self.slots[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.slots[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.slots.get(key, default)


@dataclass
class ScheduledRoutine:
    name: str
    thorn: str
    fn: Callable[[RunState], None]
    bin: str
    every: int = 1  # run when iteration % every == 0
    when: Callable[[RunState], bool] | None = None
    before: Sequence[str] = ()
    after: Sequence[str] = ()

    @property
    def qualified(self) -> str:
        return f"{self.thorn}::{self.name}"


def schedule_bin_timer_name(bin: str) -> str:
    return f"bin/{bin}"


class ScheduleError(RuntimeError):
    pass


class Scheduler:
    """Executes scheduled routines bin by bin, wrapping everything in timers."""

    def __init__(self, db: TimerDB | None = None) -> None:
        self._db = db if db is not None else timer_db()
        self._routines: dict[str, list[ScheduledRoutine]] = {b: [] for b in BINS}
        self._sorted: dict[str, list[ScheduledRoutine] | None] = {b: None for b in BINS}
        # pre-resolved scope handle (repro.timing hot path): bin and routine
        # timers are real parent/child scopes — simulation/total encloses each
        # bin, each bin encloses its routines.  Dispatch resolves handles via
        # db.scope_handle, whose already-cached fast path is one dict read.
        self._total_scope = self._db.scope_handle("simulation/total")

    @property
    def db(self) -> TimerDB:
        return self._db

    # -- registration ---------------------------------------------------------
    def schedule(
        self,
        fn: Callable[[RunState], None],
        *,
        bin: str,
        thorn: str,
        name: str | None = None,
        every: int = 1,
        when: Callable[[RunState], bool] | None = None,
        before: Sequence[str] = (),
        after: Sequence[str] = (),
    ) -> ScheduledRoutine:
        if bin not in BINS:
            raise ScheduleError(f"unknown bin {bin!r}; bins are {BINS}")
        if every < 1:
            raise ScheduleError("every must be >= 1")
        routine = ScheduledRoutine(
            name=name or fn.__name__,
            thorn=thorn,
            fn=fn,
            bin=bin,
            every=every,
            when=when,
            before=tuple(before),
            after=tuple(after),
        )
        self._routines[bin].append(routine)
        self._sorted[bin] = None
        return routine

    def routines(self, bin: str) -> list[ScheduledRoutine]:
        return list(self._routines[bin])

    # -- ordering ---------------------------------------------------------------
    def _order(self, bin: str) -> list[ScheduledRoutine]:
        cached = self._sorted[bin]
        if cached is not None:
            return cached
        routines = self._routines[bin]
        by_name: dict[str, ScheduledRoutine] = {}
        for r in routines:
            by_name[r.name] = r
            by_name[r.qualified] = r
        # Build edges: a -> b means a must run before b.
        edges: dict[str, set] = {r.qualified: set() for r in routines}
        indeg: dict[str, int] = {r.qualified: 0 for r in routines}
        def add_edge(a: ScheduledRoutine, b: ScheduledRoutine) -> None:
            if b.qualified not in edges[a.qualified]:
                edges[a.qualified].add(b.qualified)
                indeg[b.qualified] += 1
        for r in routines:
            for other in r.before:
                if other in by_name:
                    add_edge(r, by_name[other])
            for other in r.after:
                if other in by_name:
                    add_edge(by_name[other], r)
        # Kahn, stable by registration order.
        order: list[ScheduledRoutine] = []
        ready = [r for r in routines if indeg[r.qualified] == 0]
        qual_to_routine = {r.qualified: r for r in routines}
        while ready:
            r = ready.pop(0)
            order.append(r)
            for succ in sorted(edges[r.qualified]):
                indeg[succ] -= 1
                if indeg[succ] == 0:
                    ready.append(qual_to_routine[succ])
        if len(order) != len(routines):
            raise ScheduleError(f"cyclic before/after constraints in bin {bin}")
        self._sorted[bin] = order
        return order

    # -- execution ---------------------------------------------------------------
    def _run_routine(self, routine: ScheduledRoutine, state: RunState) -> None:
        with self._db.scope_handle(f"{routine.bin}/{routine.qualified}"):
            routine.fn(state)

    def attach_control_loop(
        self,
        loop,
        *,
        bin: str = "ANALYSIS",
        every: int = 1,
        thorn: str = "adapt",
        name: str = "control_loop",
    ) -> ScheduledRoutine:
        """Drive a :class:`repro.adapt.ControlLoop` from the schedule.

        The loop is polled as an ordinary scheduled routine (duck-typed: any
        object with ``poll(step)``), so control decisions are caliper-timed
        like every other routine — the cost of adapting shows up in the same
        report as the cost of computing.  Default placement is the ANALYSIS
        bin: measurements from this iteration's EVOL are in the database, and
        decisions are ready before CHECKPOINT/OUTPUT consume them.
        """
        return self.schedule(
            lambda state: loop.poll(state.iteration),
            bin=bin,
            thorn=thorn,
            name=name,
            every=every,
        )

    def run_bin(self, bin: str, state: RunState) -> None:
        with self._db.scope_handle(schedule_bin_timer_name(bin)):
            for routine in self._order(bin):
                if bin in _LOOP_BINS:
                    if routine.every > 1 and state.iteration % routine.every != 0:
                        continue
                if routine.when is not None and not routine.when(state):
                    continue
                self._run_routine(routine, state)

    def run(self, state: RunState) -> RunState:
        """Full lifecycle: STARTUP, INITIAL, loop(PRESTEP..OUTPUT), SHUTDOWN."""
        with self._total_scope:
            self.run_bin("STARTUP", state)
            self.run_bin("INITIAL", state)
            while not state.should_terminate and state.iteration < state.max_iterations:
                for bin in _LOOP_BINS:
                    self.run_bin(bin, state)
                    if state.should_terminate:
                        break
                state.iteration += 1
            self.run_bin("SHUTDOWN", state)
        return state

    def total_seconds(self) -> float:
        return self._db.get("simulation/total").seconds()
