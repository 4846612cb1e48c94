"""Prometheus/OpenMetrics export over the timer database.

The paper's premise is that timing data must be consumable *outside* the
process that recorded it; this module is that boundary for modern fleet
tooling: a :class:`MetricsExporter` renders the timer DB (plus whatever
adaptation state is wired in) as the classic text exposition format, either

* **pulled** — the monitor server serves it at ``GET /metrics``
  (``MonitorServer(..., exporter=...)``), or
* **pushed to disk** — :meth:`MetricsExporter.write_textfile` writes an atomic
  ``.prom`` file for the node_exporter textfile collector (clusters where an
  open port is not possible — same constraint :class:`StatusWriter` serves).

What is published (all under the ``repro_`` namespace):

* timer-tree nodes: inclusive/exclusive wall seconds and completed windows per
  node, labeled by scope path and the unique enclosing chain;
* ADAPT decision counts per ``controller::action`` (from the ``ADAPT/`` rows
  the control loop already writes into the DB) and checkpoint quarantines per
  reason;
* every counter channel, plus the checkpoint validation-failure counter under
  its conventional name (``*_validation_failures_total``);
* per-host straggler state when a detector is wired: cumulative step seconds,
  window counts, slowdown ratio, flagged/evicted flags;
* serving-engine stats (queue, slots, shed, KV-cache utilization) when a
  serving payload fn is wired; checkpoint-manager state when a checkpoint
  payload fn is wired;
* the exporter's own boundedness introspection (timer/bucket/channel/pending
  cardinality + parent-stats evictions) and scrape clocks — what the soak gate
  asserts stays flat/monotonic over a long run.

Rendered output always satisfies :func:`repro_torch.monitor.promparse
.parse_exposition` — the render path validates names and escapes label values,
so a scope path containing ``"`` or a newline cannot ship a malformed page.
"""

from __future__ import annotations

import math
import os
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

from ..core import clocks as _clocks
from ..core.timers import TimerDB, timer_db
from .promparse import _LABEL_RE, _METRIC_RE

__all__ = ["MetricFamily", "MetricsExporter", "TEXT_CONTENT_TYPE"]

#: the classic text exposition content type served at /metrics
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: DB row prefixes the exporter decodes into labeled decision counters
_ADAPT_PREFIX = "ADAPT/"
_QUARANTINE_PREFIX = "CHECKPOINT/quarantine::"
#: the counter channel checkpoint validation failures are bumped on
_VALIDATION_CHANNEL = "ckpt_validation_failures"

#: serving stats() keys that are cumulative -> exported as counters
_SERVING_COUNTERS = {
    "completed": ("completed_total", "Requests finished"),
    "shed": ("shed_total", "Requests shed by SLO admission/queue control"),
    "steps": ("engine_steps_total", "Engine step() iterations"),
    "tokens": ("tokens_total", "Tokens decoded"),
}
#: serving stats() keys that are instantaneous -> exported as gauges
_SERVING_GAUGES = {
    "queue_depth": ("queue_depth", "Requests waiting for a decode slot"),
    "active_slots": ("active_slots", "Occupied decode slots"),
    "max_active": ("max_active_slots", "Current batch-width ceiling"),
    "occupancy": ("slot_occupancy_ratio", "Active slots / ceiling"),
    "throughput_tokens_per_s": (
        "throughput_tokens_per_second", "Decoded tokens per busy second"),
    "mean_latency_s": ("mean_latency_seconds", "Mean request latency"),
    "p95_latency_s": ("p95_latency_seconds", "p95 request latency"),
    "p95_ttft_s": ("p95_ttft_seconds", "p95 time to first token"),
    "kv_utilization": (
        "kv_utilization_ratio", "KV-cache blocks reserved / total"),
    "kv_high_water_blocks": (
        "kv_high_water_blocks", "Peak KV-cache blocks reserved"),
}


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(value)


@dataclass
class MetricFamily:
    """One metric family: name, type, help, and its ``(labels, value)`` rows."""

    name: str
    mtype: str  # "counter" | "gauge"
    help: str
    samples: list[tuple[dict[str, str], float]] = field(default_factory=list)

    def render(self) -> list[str]:
        if not _METRIC_RE.match(self.name):
            raise ValueError(f"invalid metric name {self.name!r}")
        if self.mtype == "counter" and not self.name.endswith("_total"):
            raise ValueError(f"counter {self.name!r} must be named *_total")
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.mtype}",
        ]
        for labels, value in self.samples:
            if labels:
                for key in labels:
                    if not _LABEL_RE.match(key) or key.startswith("__"):
                        raise ValueError(f"invalid label name {key!r}")
                body = ",".join(
                    f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()
                )
                lines.append(f"{self.name}{{{body}}} {_format_value(value)}")
            else:
                lines.append(f"{self.name} {_format_value(value)}")
        return lines


class MetricsExporter:
    """Render the timer DB (+ wired adaptation state) as Prometheus metrics.

    Everything beyond ``db`` is optional wiring, mirroring
    :class:`~repro_torch.monitor.server.MonitorServer`:

    control_loop:
        A :class:`repro_torch.adapt.ControlLoop`; adds the poll counter (decision
        counts themselves come from the DB rows the loop writes, so they are
        exported even without this).
    detector:
        A :class:`repro_torch.dist.stragglers.StragglerDetector`; adds the per-host
        families.
    serving_fn / checkpoint_fn / fleet_fn:
        The same payload callables the monitor endpoints use
        (``serving_payload(engine)`` / ``manager.status_payload`` /
        ``FleetController.status_payload``).
    """

    def __init__(
        self,
        db: TimerDB | None = None,
        *,
        namespace: str = "repro",
        control_loop=None,
        detector=None,
        serving_fn: Callable[[], dict[str, Any]] | None = None,
        checkpoint_fn: Callable[[], dict[str, Any]] | None = None,
        fleet_fn: Callable[[], dict[str, Any]] | None = None,
    ) -> None:
        if not _METRIC_RE.match(namespace):
            raise ValueError(f"invalid metric namespace {namespace!r}")
        self._db = db
        self.namespace = namespace
        self._control_loop = control_loop
        self._detector = detector
        self._serving_fn = serving_fn
        self._checkpoint_fn = checkpoint_fn
        self._fleet_fn = fleet_fn

    @property
    def db(self) -> TimerDB:
        return self._db if self._db is not None else timer_db()

    # -- collection ------------------------------------------------------------
    def collect(self) -> list[MetricFamily]:
        ns = self.namespace
        db = self.db
        families: list[MetricFamily] = []

        def add(name, mtype, help_, samples):
            families.append(MetricFamily(f"{ns}_{name}", mtype, help_, samples))

        # timer tree: one row per tree node; `chain` ('>'-joined ancestor
        # paths) keeps label sets unique when a shared timer splits under
        # several enclosing scopes
        inclusive, exclusive, windows = [], [], []
        todo = [((), node) for node in db.tree()]
        while todo:
            chain, node = todo.pop()
            labels = {"path": node.name, "chain": ">".join(chain)}
            inclusive.append((labels, node.inclusive))
            exclusive.append((dict(labels), node.exclusive))
            windows.append((dict(labels), float(node.count)))
            todo.extend((chain + (node.name,), c) for c in node.children)
        add("timer_inclusive_seconds", "gauge",
            "Accumulated wall seconds per timer-tree node (children included)",
            inclusive)
        add("timer_exclusive_seconds", "gauge",
            "Self wall seconds per timer-tree node (children subtracted)",
            exclusive)
        add("timer_windows_total", "counter",
            "Completed start/stop windows per timer-tree node", windows)

        # ADAPT decisions + checkpoint quarantines, decoded from the rows the
        # control plane publishes (external visibility needs only the DB)
        prefix = (
            f"{self._control_loop.prefix}/"
            if self._control_loop is not None
            else _ADAPT_PREFIX
        )
        actions, quarantines = [], []
        for timer in db.timers():
            name = timer.name
            if name.startswith(prefix) and "::" in name:
                controller, action = name[len(prefix):].split("::", 1)
                actions.append((
                    {"controller": controller, "action": action},
                    float(timer.count),
                ))
            elif name.startswith(_QUARANTINE_PREFIX):
                quarantines.append((
                    {"reason": name[len(_QUARANTINE_PREFIX):]},
                    float(timer.count),
                ))
        add("adapt_actions_total", "counter",
            "Control-plane decisions taken, per controller::action", actions)
        if self._control_loop is not None:
            add("adapt_polls_total", "counter",
                "Control-loop poll() calls",
                [({}, float(self._control_loop.polls))])
        add("checkpoint_quarantine_total", "counter",
            "Checkpoints quarantined at resume, per reason", quarantines)

        # counter channels (+ the ckptkit-conventional alias for validation
        # failures)
        names = _clocks.counter_names()
        values = _clocks.counter_values(names)
        add("counter_total", "counter",
            "Counter-channel totals (lock-free increment channels)",
            [({"channel": n}, v) for n, v in zip(names, values)])
        if _VALIDATION_CHANNEL in names:
            add("checkpoint_validation_failures_total", "counter",
                "Checkpoints that failed validation at resume scan",
                [({}, values[names.index(_VALIDATION_CHANNEL)])])

        if self._detector is not None:
            families.extend(self._collect_hosts())
        if self._serving_fn is not None:
            families.extend(self._collect_serving())
        if self._checkpoint_fn is not None:
            families.extend(self._collect_checkpoints())
        if self._fleet_fn is not None:
            families.extend(self._collect_fleet())

        # boundedness introspection + scrape clocks (the soak invariants)
        card = db.cardinality()
        cstats = _clocks.counter_stats()
        add("timing_timers", "gauge", "Timers in the database",
            [({}, float(card["timers"]))])
        add("timing_scope_handles", "gauge", "Cached scope handles",
            [({}, float(card["scope_handles"]))])
        add("timing_parent_stats_buckets", "gauge",
            "Parent-chain attribution buckets across all timers",
            [({}, float(card["parent_stats_buckets"]))])
        add("timing_parent_stats_buckets_max", "gauge",
            "Largest single timer's parent-chain bucket count",
            [({}, float(card["parent_stats_buckets_max"]))])
        add("timing_parent_stats_evictions_total", "counter",
            "Attribution buckets evicted at the per-timer LRU cap",
            [({}, float(card["parent_stats_evictions"]))])
        add("timing_counter_channels", "gauge", "Counter channels created",
            [({}, float(cstats["channels"]))])
        add("timing_counter_pending", "gauge",
            "Unfolded counter amounts across all pending lists",
            [({}, float(cstats["pending_total"]))])
        add("timing_counter_pending_max", "gauge",
            "Largest single channel's unfolded pending list",
            [({}, float(cstats["pending_max"]))])
        add("scrape_monotonic_seconds", "gauge",
            "time.monotonic() at collection (soak monotonicity probe)",
            [({}, time.monotonic())])
        add("scrape_walltime_seconds", "gauge",
            "time.time() at collection", [({}, time.time())])
        return families

    def _collect_hosts(self) -> list[MetricFamily]:
        ns = self.namespace
        det = self._detector
        stats = det.host_stats()
        report = det.reports[-1] if det.reports else None
        flagged = set(report.stragglers) if report is not None else set()
        seconds, windows, slowdown, flag_rows, evict_rows = [], [], [], [], []
        for host in range(det.n_hosts):
            labels = {"host": str(host)}
            count, total = stats.get(host, (0, 0.0))
            seconds.append((labels, total))
            windows.append((dict(labels), float(count)))
            if report is not None and host not in det.evicted:
                slowdown.append((dict(labels), report.slowdown(host)))
            flag_rows.append((dict(labels), float(host in flagged)))
            evict_rows.append((dict(labels), float(host in det.evicted)))
        return [
            MetricFamily(f"{ns}_host_step_seconds_total", "counter",
                         "Cumulative observed step seconds per host", seconds),
            MetricFamily(f"{ns}_host_windows_total", "counter",
                         "Step windows observed per host", windows),
            MetricFamily(f"{ns}_host_slowdown_ratio", "gauge",
                         "Host mean step time / fleet median (last report)",
                         slowdown),
            MetricFamily(f"{ns}_host_flagged", "gauge",
                         "1 when the last report flags the host as a straggler",
                         flag_rows),
            MetricFamily(f"{ns}_host_evicted", "gauge",
                         "1 when the host has been evicted", evict_rows),
        ]

    def _collect_serving(self) -> list[MetricFamily]:
        ns = self.namespace
        payload = self._serving_fn()
        engine = payload.get("engine", payload) if isinstance(payload, dict) else {}
        out: list[MetricFamily] = []
        for key, (suffix, help_) in _SERVING_COUNTERS.items():
            if key in engine:
                out.append(MetricFamily(
                    f"{ns}_serving_{suffix}", "counter", help_,
                    [({}, float(engine[key]))],
                ))
        for key, (suffix, help_) in _SERVING_GAUGES.items():
            if key in engine:
                out.append(MetricFamily(
                    f"{ns}_serving_{suffix}", "gauge", help_,
                    [({}, float(engine[key]))],
                ))
        return out

    def _collect_checkpoints(self) -> list[MetricFamily]:
        ns = self.namespace
        payload = self._checkpoint_fn() or {}
        checkpoints = payload.get("checkpoints", [])
        totals = payload.get("totals", {})
        out = [
            MetricFamily(f"{ns}_checkpoints_on_disk", "gauge",
                         "Valid checkpoints currently retained",
                         [({}, float(len(checkpoints)))]),
            MetricFamily(f"{ns}_checkpoints_quarantined", "gauge",
                         "Checkpoints moved aside as corrupt",
                         [({}, float(len(payload.get("quarantined", []))))]),
        ]
        if checkpoints:
            out.append(MetricFamily(
                f"{ns}_checkpoint_last_success_step", "gauge",
                "Step of the newest retained checkpoint",
                [({}, float(max(c["step"] for c in checkpoints)))],
            ))
        for key, suffix, help_ in (
            ("n_saves", "saves_total", "Checkpoint saves issued"),
            ("total_bytes", "write_bytes_total", "Checkpoint bytes written"),
            ("total_blocking_seconds", "blocking_seconds_total",
             "Seconds the training loop blocked on checkpoint writes"),
        ):
            if key in totals:
                out.append(MetricFamily(
                    f"{ns}_checkpoint_{suffix}", "counter", help_,
                    [({}, float(totals[key]))],
                ))
        return out

    def _collect_fleet(self) -> list[MetricFamily]:
        ns = self.namespace
        payload = self._fleet_fn() or {}
        hosts = payload.get("hosts", {})
        return [
            MetricFamily(f"{ns}_fleet_hosts", "gauge",
                         "Hosts currently in the fleet membership",
                         [({}, float(len(hosts)))]),
            MetricFamily(f"{ns}_fleet_membership_epoch", "gauge",
                         "Membership epoch (bumps on every join/leave; the "
                         "transport fence)",
                         [({}, float(payload.get("epoch", 0)))]),
            MetricFamily(f"{ns}_fleet_host_share", "gauge",
                         "Microbatches assigned per member host",
                         [({"host": str(h)}, float(e.get("share", 0)))
                          for h, e in hosts.items()]),
            MetricFamily(f"{ns}_fleet_joins_total", "counter",
                         "Hosts admitted mid-run",
                         [({}, float(payload.get("joins_total", 0)))]),
            MetricFamily(f"{ns}_fleet_leaves_total", "counter",
                         "Hosts removed on heartbeat expiry",
                         [({}, float(payload.get("leaves_total", 0)))]),
            MetricFamily(f"{ns}_fleet_reshard_defers_total", "counter",
                         "Membership changes skipped by the payback gate",
                         [({}, float(payload.get("reshard_defers_total", 0)))]),
            MetricFamily(f"{ns}_fleet_stale_samples_total", "counter",
                         "Samples rejected by the transport epoch fence",
                         [({}, float(payload.get("stale_samples_rejected", 0)))]),
        ]

    # -- output ----------------------------------------------------------------
    def render(self) -> str:
        """The full text exposition (always ends with a newline)."""
        lines: list[str] = []
        for family in self.collect():
            lines.extend(family.render())
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: str) -> str:
        """Atomically write the exposition for the node_exporter textfile
        collector: render, write ``<path>.<pid>.tmp`` beside the target, then
        ``os.replace`` — a scraper never sees a half-written page."""
        body = self.render()
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(body)
        os.replace(tmp, path)
        return path
