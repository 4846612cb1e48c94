"""Read-side facade helpers: the tree and rollup queries over the active
database (explicit ``db=`` overrides; otherwise the entered
:class:`~repro.timing.session.TimingSession`'s database, falling back to the
process-global one)."""

from __future__ import annotations

from ..core.report import format_tree_report
from ..core.timers import TimerDB, TimerNode, timer_db

__all__ = ["format_tree", "total_seconds", "tree"]


def tree(db: TimerDB | None = None) -> list[TimerNode]:
    """The parent/child timer forest (inclusive + exclusive seconds per node)."""
    db = db if db is not None else timer_db()
    return db.tree()


def format_tree(db: TimerDB | None = None, prefix: str = "", title: str = "Timer tree") -> str:
    """Render the hierarchical Fig.-2 report (indented inclusive/exclusive table)."""
    db = db if db is not None else timer_db()
    return format_tree_report(db, title=title, prefix=prefix)


def total_seconds(prefix: str = "", db: TimerDB | None = None) -> float:
    """Rollup: wall seconds summed over the timers at/under ``prefix``
    (whole path segments — ``"serve"`` never matches ``server_x``)."""
    db = db if db is not None else timer_db()
    return db.total_seconds(prefix)
