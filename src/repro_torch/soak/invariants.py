"""Soak invariants: what must hold across a run's exporter snapshots.

Each snapshot is an externally scraped (or rendered) ``/metrics`` page, parsed
by the strict exposition parser.  The checks below are the ROADMAP's
long-run-boundedness contract, asserted on the *external* view — if a metric
is wrong on the wire, it is wrong here, no matter what the in-process state
says:

* every snapshot parses cleanly (collected during the run);
* the scrape monotonic clock strictly increases and no ``*_total`` series
  ever decreases or disappears (monotonic-clock anomalies / counter resets);
* every ADAPT action recorded by the control loop is visible as a metrics
  delta: at each snapshot the scraped ``*_adapt_actions_total`` series equal
  the loop's decision log taken just before the scrape, series-for-series;
* cardinality is flat over the steady tail: timers, timer-tree series,
  parent-stats buckets, and counter channels stop growing once injected
  faults have settled, and parent-stats / pending-list sizes respect their
  design caps throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..core.clocks import _PENDING_FOLD_CAP
from ..core.timers import PARENT_STATS_CAP
from ..monitor.promparse import Exposition

__all__ = ["SnapshotRecord", "check_snapshots"]


@dataclass
class SnapshotRecord:
    """One scraped exporter page plus the in-process truth captured
    immediately before the scrape (the delta baseline)."""

    index: int
    step: int
    source: str  # "http" | "render"
    #: control-loop ``{controller::action: count}`` taken just before scraping
    actions: dict[str, int] = field(default_factory=dict)
    exposition: Exposition | None = None
    parse_error: str | None = None
    path: str | None = None  # written .prom file, when out_dir is set

    def gauge(self, name: str, default: float = 0.0) -> float:
        try:
            return self.exposition.value(name)
        except (AttributeError, KeyError):
            return default


def _fail(failures: list[str], message: str) -> None:
    failures.append(message)


def check_snapshots(
    snapshots: list[SnapshotRecord],
    *,
    namespace: str = "repro",
    tail_fraction: float = 0.25,
) -> list[str]:
    """Run every invariant over the snapshot sequence; returns failures."""
    failures: list[str] = []
    ns = namespace
    if len(snapshots) < 2:
        _fail(failures, f"need >= 2 snapshots to check invariants, got {len(snapshots)}")
        return failures

    # -- 1. exposition validity ------------------------------------------------
    for snap in snapshots:
        if snap.parse_error is not None:
            _fail(failures, f"snapshot {snap.index}: malformed exposition: {snap.parse_error}")
    parsed = [s for s in snapshots if s.exposition is not None]
    if len(parsed) < 2:
        return failures

    # -- 2. monotonicity -------------------------------------------------------
    last_mono = None
    for snap in parsed:
        mono = snap.gauge(f"{ns}_scrape_monotonic_seconds")
        if last_mono is not None and mono <= last_mono:
            _fail(failures,
                  f"snapshot {snap.index}: monotonic clock went "
                  f"{last_mono:.6f} -> {mono:.6f}")
        last_mono = mono
    prev_totals: dict[tuple[str, Any], float] = {}
    for snap in parsed:
        totals = {
            key: v
            for key, v in snap.exposition.samples.items()
            if key[0].endswith("_total")
        }
        for key, prev_v in prev_totals.items():
            if key not in totals:
                _fail(failures,
                      f"snapshot {snap.index}: series {key[0]}{dict(key[1])} "
                      "disappeared")
            elif totals[key] < prev_v:
                _fail(failures,
                      f"snapshot {snap.index}: counter {key[0]}{dict(key[1])} "
                      f"decreased {prev_v} -> {totals[key]}")
        prev_totals = totals

    # membership epoch: when the fleet families are exported, the epoch may
    # only climb — a snapshot showing a lower epoch than its predecessor means
    # a membership record regressed (or a stale controller overwrote a newer
    # one), which breaks the transport's fencing contract
    epoch_metric = f"{ns}_fleet_membership_epoch"
    last_epoch = None
    for snap in parsed:
        if (epoch_metric, ()) not in snap.exposition.samples:
            continue
        epoch = snap.gauge(epoch_metric)
        if last_epoch is not None and epoch < last_epoch:
            _fail(failures,
                  f"snapshot {snap.index}: membership epoch regressed "
                  f"{last_epoch:g} -> {epoch:g}")
        last_epoch = epoch

    # -- 3. ADAPT external visibility ------------------------------------------
    metric = f"{ns}_adapt_actions_total"
    for snap in parsed:
        seen = {
            f"{dict(labels)['controller']}::{dict(labels)['action']}": v
            for labels, v in snap.exposition.series(metric).items()
        }
        for key, count in snap.actions.items():
            if seen.get(key) != float(count):
                _fail(failures,
                      f"snapshot {snap.index}: action {key} taken {count}x "
                      f"but metrics show {seen.get(key)}")
        for key, v in seen.items():
            if key not in snap.actions and v != 0.0:
                _fail(failures,
                      f"snapshot {snap.index}: metrics report {v:g}x {key} "
                      "the decision log never took")

    # -- 4. bounded cardinality over the steady tail ---------------------------
    for snap in parsed:
        buckets_max = snap.gauge(f"{ns}_timing_parent_stats_buckets_max")
        if buckets_max > PARENT_STATS_CAP:
            _fail(failures,
                  f"snapshot {snap.index}: parent-stats bucket count "
                  f"{buckets_max:g} exceeds the {PARENT_STATS_CAP} cap")
        pending_max = snap.gauge(f"{ns}_timing_counter_pending_max")
        if pending_max > _PENDING_FOLD_CAP:
            _fail(failures,
                  f"snapshot {snap.index}: counter pending list at "
                  f"{pending_max:g} exceeds the {_PENDING_FOLD_CAP} fold cap")
    tail = parsed[-max(2, int(len(parsed) * tail_fraction)):]
    for gauge_name in (
        f"{ns}_timing_timers",
        f"{ns}_timing_counter_channels",
        f"{ns}_timing_parent_stats_buckets",
    ):
        first, last = tail[0].gauge(gauge_name), tail[-1].gauge(gauge_name)
        if last > first:
            _fail(failures,
                  f"{gauge_name} grew over the steady tail: "
                  f"{first:g} -> {last:g} "
                  f"(snapshots {tail[0].index}..{tail[-1].index})")
    first_series = len(tail[0].exposition.series(f"{ns}_timer_windows_total"))
    last_series = len(tail[-1].exposition.series(f"{ns}_timer_windows_total"))
    if last_series > first_series:
        _fail(failures,
              f"timer-tree series grew over the steady tail: "
              f"{first_series} -> {last_series}")
    return failures
