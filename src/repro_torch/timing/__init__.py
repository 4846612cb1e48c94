"""``repro.timing`` — the public facade over the timer infrastructure.

One coherent, hierarchical, scope-based API replacing the four overlapping
entry points that grew around the flat Cactus-style timer database
(``TimerDB.start/stop`` by name or handle, ``db.timing(...)``, the flat
``timed()`` decorator, raw counter cells):

* **Scopes** (write side): ``with scope("forward"):`` nests under the
  enclosing scope via the thread-local running stack, forming path-addressed
  timers (``train/step/forward``).  Hot loops pre-resolve a path once with
  ``h = scope_handle("train/step")`` and enter the handle — the array-backed
  fused start/stop window with zero dict lookups.
* **Counters**: ``counter("tokens")`` resolves the lock-free counter cell,
  namespaced under the scope active at resolution time.
* **Decorator**: ``@timed()`` opens a scope per call under the *caller's*
  active scope.
* **Sessions**: ``with session() as ts:`` bundles a database + scheduler +
  control loop and installs the database as the process default — no more
  ``reset_timer_db()`` juggling.
* **Read side**: ``tree()`` builds the parent/child forest with inclusive and
  exclusive (self minus children) seconds; ``format_tree()`` renders the
  hierarchical Fig.-2 report; ``total_seconds("serve")`` rolls up whole path
  segments.
* **Span log**: while a ``torch.profiler`` session records, every timer
  window also logs a :class:`~repro_torch.core.timers.SpanEntry` (path,
  parent, host start/end on ``time.perf_counter_ns``) and, on the card, its
  CUDA-event seconds into the counter channel ``<path>/device_s``;
  ``span_log(lo_ns, hi_ns)`` reads the log.

The old surfaces keep working (``repro.core`` re-exports are unchanged;
``db.timing``/``core.timers.timed`` emit ``DeprecationWarning``); this module
is the supported way in.  Guarded by ``tests/test_api_surface.py``.
"""

from ..core.timers import (
    ScopeHandle,
    SpanEntry,
    Timer,
    TimerDB,
    TimerNode,
    span_log,
    timer_db,
)
from .reporting import format_tree, total_seconds, tree
from .scopes import counter, current_scope, scope, scope_handle, timed
from .session import TimingSession, current_session, session

__all__ = [
    "ScopeHandle",
    "SpanEntry",
    "Timer",
    "TimerDB",
    "TimerNode",
    "TimingSession",
    "counter",
    "current_scope",
    "current_session",
    "format_tree",
    "scope",
    "scope_handle",
    "session",
    "span_log",
    "timed",
    "timer_db",
    "total_seconds",
    "tree",
]
