"""Hierarchical scopes — the call-path-facing half of the ``repro.timing``
facade.

A *scope* is a caliper window whose timer path is derived from runtime
nesting: ``scope("forward")`` inside ``scope("step")`` inside ``scope("train")``
records the timer ``train/step/forward`` with parent/child attribution taken
from the thread-local running stack (SPACE-Timers style — no nesting
annotations, the call structure *is* the hierarchy).  Two forms:

* :func:`scope` — dynamic: the path is joined under the enclosing scope at
  entry.  Use for cold/one-off regions and wherever the nesting varies.
* :func:`scope_handle` — pre-resolved: an **absolute** path resolved to its
  timer once; entering the returned handle is the array-backed fused
  start/stop window with zero dict lookups.  Use for hot loops.

:func:`counter` and :func:`timed` round out the surface: counters resolve
their channel name under the scope active *at resolution time* (resolve once,
bump lock-free forever), and the decorator opens a scope per call under
whatever scope the caller is running.
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Iterator
from contextlib import contextmanager

from ..core.clocks import counter_cell
from ..core.timers import ScopeHandle, Timer, TimerDB, timer_db

__all__ = ["counter", "current_scope", "scope", "scope_handle", "timed"]


@contextmanager
def scope(name: str, db: TimerDB | None = None) -> Iterator[Timer]:
    """Open a hierarchical scope named ``name`` under the enclosing scope.

    The timer path is ``<enclosing path>/<name>`` (just ``name`` at top
    level); ``name`` may contain ``/`` segments of its own.  Yields the
    :class:`~repro.core.timers.Timer` so in-scope code can read it live.
    """
    db = db if db is not None else timer_db()
    with db.scope(name) as timer:
        yield timer


def scope_handle(path: str, db: TimerDB | None = None) -> ScopeHandle:
    """Pre-resolve an **absolute** scope path for hot-loop use.

    Resolution (path → timer object) happens once and is cached per
    database; ``with handle:`` is then the fused-sampler fast path — no
    name lookups, no database lock.  Parent attribution stays dynamic: each
    entry records whichever scope is active on the current thread.
    """
    db = db if db is not None else timer_db()
    return db.scope_handle(path)


def current_scope(db: TimerDB | None = None) -> str:
    """The calling thread's innermost active scope path (``""`` outside)."""
    db = db if db is not None else timer_db()
    return db.current_scope()


def counter(name: str, *, absolute: bool = False, db: TimerDB | None = None) -> Callable[[float], None]:
    """Resolve a lock-free counter cell, namespaced under the current scope.

    Returns the same C-level bound-append cell as
    :func:`repro.core.clocks.counter_cell`, with the channel name prefixed by
    the scope path active at *resolution* time (``counter("tokens")`` inside
    ``scope("serve")`` bumps channel ``serve/tokens``).  Resolve once, bump
    from any thread.  ``absolute=True`` skips the namespacing and addresses
    the process-global channel directly (e.g. channels a registered
    :class:`~repro.core.clocks.CounterClock` exports, like ``io_bytes``).

    Scoped (non-absolute) channels are auto-exported through the session
    CounterClock (:func:`repro.timing.session.export_counter_channel`), so
    they render in timer reports without any manual clock registration;
    absolute names are left alone — they usually address channels an existing
    clock already exports, and double-exporting would collide.
    """
    if not absolute:
        path = (db if db is not None else timer_db()).current_scope()
        if path:
            name = f"{path}/{name}"
        from .session import export_counter_channel

        export_counter_channel(name)
    return counter_cell(name)


def timed(name: str | None = None, db: TimerDB | None = None) -> Callable:
    """Decorator opening a scope around every call of the function.

    Unlike the removed flat ``repro.core.timers.timed``, the scope nests
    under the **caller's** active scope at call time: a helper decorated
    ``@timed("build")`` called from inside ``scope("train")`` records
    ``train/build``; the same helper called bare records ``build``.  The
    default name is the function's qualified name.
    """

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            d = db if db is not None else timer_db()
            with d.scope(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
