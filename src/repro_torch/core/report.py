"""Timer reports (paper Sec. 3.1, Fig. 2) — human tables, JSON logs, periodic output.

``format_report`` renders the Fig.-2-style table: one row per timer, one column
per clock channel, grouped by schedule bin, with a "Total time for simulation"
footer — and, when handed a control loop, an ``ADAPT/`` section recording
every runtime-adaptation decision (when, trigger channel, action taken).
``TimerLogger`` appends JSON snapshots to a log file ("logged
semi-automatically for post-mortem review").
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Mapping, Sequence

from .timers import TimerDB, TimerNode, path_matches, timer_db

__all__ = [
    "format_report",
    "format_tree_report",
    "report_rows",
    "tree_rows",
    "straggler_rows",
    "adapt_rows",
    "format_adapt_report",
    "TimerLogger",
    "bin_distribution",
]


def _channel_value(flat: dict[str, float], channel: str) -> float:
    """Look up a flat channel, tolerating collision-namespaced layouts.

    When two clocks export the same channel name the snapshot renames every
    colliding export ``<clock>.<channel>``; a report column asked for by plain
    name then takes the *first* namespaced export (layout order, i.e. clock
    registration order).  Colliding clocks frequently read the same underlying
    source, so summing would double-count; picking one is deterministic and
    right whenever the sources agree.
    """
    value = flat.get(channel)
    if value is not None:
        return value
    suffix = "." + channel
    for key, v in flat.items():
        if key.endswith(suffix):
            return v
    return 0.0


def report_rows(
    db: TimerDB | None = None,
    channels: Sequence[str] = ("walltime", "cputime"),
    prefix: str = "",
) -> list[dict[str, object]]:
    db = db if db is not None else timer_db()
    rows: list[dict[str, object]] = []
    for timer in db.timers():
        if prefix and not path_matches(timer.name, prefix):
            continue
        flat = timer.read_flat()
        row: dict[str, object] = {"timer": timer.name, "count": timer.count}
        for ch in channels:
            row[ch] = _channel_value(flat, ch)
        rows.append(row)
    return rows


def straggler_rows(
    detector,
    channels: Sequence[str] = ("walltime", "cputime"),
    prefix: str = "DIST",
) -> list[dict[str, object]]:
    """Fleet-health rows from a ``repro.dist.stragglers.StragglerDetector``.

    Shaped exactly like :func:`report_rows` entries (one row per reporting
    host, walltime = that host's total step seconds) for JSON summaries and
    monitor endpoints; hosts flagged by the detector's most recent check are
    tagged ``[STRAGGLER]`` and hosts removed from the fleet ``[EVICTED]``.
    The Fig.-2 table itself needs no merging — the detector's ``check()``
    publishes ``DIST/host{h}::step`` timers straight into the timer DB, which
    :func:`format_report` renders like any other timer.  Duck-typed (needs
    ``host_stats()``/``reports``) to keep ``core`` free of a ``dist`` import.
    """
    latest = detector.reports[-1] if getattr(detector, "reports", None) else None
    evicted = getattr(detector, "evicted", ()) or ()
    rows: list[dict[str, object]] = []
    for host, (count, total) in sorted(detector.host_stats().items()):
        name = f"{prefix}/host{host}::step"
        if host in evicted:
            name += " [EVICTED]"
        elif latest is not None and host in latest.stragglers:
            name += " [STRAGGLER]"
        row: dict[str, object] = {"timer": name, "count": count}
        for ch in channels:
            row[ch] = total if ch == "walltime" else 0.0
        rows.append(row)
    return rows


def adapt_rows(loop) -> list[dict[str, object]]:
    """Decision-log rows from a ``repro.adapt.ControlLoop``.

    One row per recorded :class:`~repro.adapt.controller.ControlAction` —
    when (step), who (controller), what (action), why (trigger channel), and
    the action's parameters — for JSON summaries and monitor endpoints.
    Duck-typed (needs ``.actions``) to keep ``core`` free of an ``adapt``
    import; the aggregate ``ADAPT/<controller>::<action>`` count rows are
    published into the timer DB by the loop itself.
    """
    return [
        {
            "step": a.step,
            "controller": a.controller,
            "action": a.action,
            "trigger": a.trigger,
            "detail": dict(a.detail),
        }
        for a in getattr(loop, "actions", ())
    ]


def format_adapt_report(loop, title: str = "ADAPT decisions") -> str:
    """Render the control loop's decision log as a table (the ``ADAPT/``
    section of the Fig.-2 report): one line per decision with the step it
    fired on, the controller, the action taken, and the trigger channel."""
    rows = adapt_rows(loop)
    header = f"{title} ({len(rows)})"
    if not rows:
        return f"{header}\n{'=' * len(header)}\n(no adaptation decisions recorded)"
    step_w = max(len("step"), *(len(str(r["step"])) for r in rows))
    ctrl_w = max(len("controller"), *(len(str(r["controller"])) for r in rows)) + 2
    act_w = max(len("action"), *(len(str(r["action"])) for r in rows)) + 2
    trig_w = max(len("trigger"), *(len(str(r["trigger"])) for r in rows)) + 2
    lines = [header, "=" * len(header)]
    lines.append(
        "step".rjust(step_w)
        + "  " + "controller".ljust(ctrl_w)
        + "action".ljust(act_w)
        + "trigger".ljust(trig_w)
        + "detail"
    )
    lines.append("-" * len(lines[-1]))
    for r in rows:
        detail = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r["detail"].items()
        )
        lines.append(
            str(r["step"]).rjust(step_w)
            + "  " + str(r["controller"]).ljust(ctrl_w)
            + str(r["action"]).ljust(act_w)
            + str(r["trigger"]).ljust(trig_w)
            + detail
        )
    return "\n".join(lines)


def format_report(
    db: TimerDB | None = None,
    channels: Sequence[str] = ("walltime", "cputime"),
    prefix: str = "",
    title: str = "Timer report",
    adapt=None,
) -> str:
    """Render the standard timer report (cf. paper Fig. 2).

    Pass a ``repro.adapt.ControlLoop`` as ``adapt`` to append the ``ADAPT/``
    decision-log section (every runtime adaptation: when, trigger channel,
    action taken) under the timer table.
    """
    db = db if db is not None else timer_db()
    rows = report_rows(db, channels, prefix)
    name_w = max([len(r["timer"]) for r in rows] + [len("Timer")]) + 2
    col_w = 22
    lines = [title, "=" * (name_w + (col_w + 1) * (len(channels) + 1))]
    header = "Timer".ljust(name_w) + "count".rjust(col_w)
    for ch in channels:
        header += " " + ch.rjust(col_w)
    lines.append(header)
    lines.append("-" * len(header))
    for row in sorted(rows, key=lambda r: r["timer"]):
        line = str(row["timer"]).ljust(name_w) + str(row["count"]).rjust(col_w)
        for ch in channels:
            line += " " + f"{float(row.get(ch, 0.0)):.8f}"[:col_w].rjust(col_w)
        lines.append(line)
    total = db.get("simulation/total").read_flat() if db.exists("simulation/total") else {}
    if total:
        lines.append("-" * len(header))
        line = "Total time for simulation".ljust(name_w) + "".rjust(col_w)
        for ch in channels:
            line += " " + f"{_channel_value(total, ch):.8f}"[:col_w].rjust(col_w)
        lines.append(line)
    if adapt is not None:
        lines.append("")
        lines.append(format_adapt_report(adapt))
    return "\n".join(lines)


def _tree_select(roots: list[TimerNode], prefix: str) -> list[TimerNode]:
    """Subtrees rooted at the outermost nodes matching ``prefix`` (whole
    path segments, like ``TimerDB.total_seconds``) — a nested scope such as
    ``bin/EVOL`` is found wherever it sits in the forest, not only at root."""
    if not prefix:
        return roots
    selected: list[TimerNode] = []

    def visit(node: TimerNode) -> None:
        if path_matches(node.name, prefix):
            selected.append(node)
            return  # keep the whole subtree; don't re-match descendants
        for child in node.children:
            visit(child)

    for root in roots:
        visit(root)
    return selected


def tree_rows(db: TimerDB | None = None, prefix: str = "") -> list[dict[str, object]]:
    """The timer forest as nested JSON-ready dicts.

    One dict per :class:`~repro.core.timers.TimerNode` — ``timer``, ``count``,
    ``inclusive_s``, ``exclusive_s``, ``children`` (recursively) — the payload
    the monitor serves at ``/tree``.  ``prefix`` selects the subtrees rooted
    at the outermost matching nodes, wherever they sit in the forest.
    """
    db = db if db is not None else timer_db()

    def convert(node: TimerNode) -> dict[str, object]:
        return {
            "timer": node.name,
            "count": node.count,
            "inclusive_s": node.inclusive,
            "exclusive_s": node.exclusive,
            "children": [convert(c) for c in node.children],
        }

    return [convert(root) for root in _tree_select(db.tree(), prefix)]


def format_tree_report(
    db: TimerDB | None = None,
    title: str = "Timer tree",
    prefix: str = "",
) -> str:
    """Render the hierarchical Fig.-2 report: one row per timer, indented by
    scope depth, with inclusive (subtree) and exclusive (self minus children)
    wall seconds — the stack-derived tree view of the flat table.  ``prefix``
    selects the subtrees rooted at the outermost matching nodes, wherever
    they sit in the forest."""
    db = db if db is not None else timer_db()
    roots = _tree_select(db.tree(), prefix)
    flat: list[tuple[int, TimerNode]] = []
    for root in roots:
        flat.extend(root.walk())
    name_w = max([2 * lvl + len(n.name) for lvl, n in flat] + [len("Timer")]) + 2
    col_w = 16
    header = (
        "Timer".ljust(name_w)
        + "count".rjust(8)
        + "inclusive_s".rjust(col_w)
        + "exclusive_s".rjust(col_w)
    )
    lines = [title, "=" * len(header), header, "-" * len(header)]
    for lvl, node in flat:
        lines.append(
            ("  " * lvl + node.name).ljust(name_w)
            + str(node.count).rjust(8)
            + f"{node.inclusive:.8f}"[:col_w].rjust(col_w)
            + f"{node.exclusive:.8f}"[:col_w].rjust(col_w)
        )
    if not flat:
        lines.append("(no timers)")
    return "\n".join(lines)


def bin_distribution(db: TimerDB | None = None) -> dict[str, float]:
    """Wall-time distribution over schedule bins (paper Fig. 1 right)."""
    db = db if db is not None else timer_db()
    out: dict[str, float] = {}
    for timer in db.timers():
        if timer.name.startswith("bin/"):
            out[timer.name[len("bin/"):]] = timer.seconds()
    return out


class TimerLogger:
    """Appends timer-DB snapshots as JSON lines for post-mortem review."""

    def __init__(self, path: str, db: TimerDB | None = None) -> None:
        self.path = path
        self._db = db if db is not None else timer_db()
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        # a writer killed mid-line (SIGKILL during log()) leaves a partial
        # trailing record; terminate it so this logger's first append starts
        # on a fresh line instead of fusing two records into garbage
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
        except FileNotFoundError:
            pass

    def log(self, iteration: int, extra: Mapping[str, object] | None = None) -> None:
        record = {
            "t": time.time(),
            "iteration": iteration,
            "timers": self._db.snapshot(),
        }
        if extra:
            record["extra"] = dict(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read_all(self) -> list[dict]:
        """Parse every complete record; a torn line from a killed writer is
        skipped rather than raised (its step is re-logged on resume anyway)."""
        if not os.path.exists(self.path):
            return []
        out: list[dict] = []
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out
