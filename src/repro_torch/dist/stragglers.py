"""Straggler detection from cross-host timer reductions (paper Sec. 1 & 5).

The paper's adaptive story needs timing data aggregated *across processes*: a
large run profiles itself and reacts.  :class:`StragglerDetector` is that
reduction point for step walltimes — each host's per-step seconds stream in
(directly via :meth:`observe`, sampled out of the timer database via
:meth:`observe_timer`, or all-gathered from every host through an injectable
:class:`LocalTransport`), and :meth:`check` compares per-host windowed means
against the fleet median.  Hosts slower than ``threshold`` x median are flagged
in a :class:`StragglerReport`, handed to the ``on_straggler`` callback (the
hook a launcher uses to re-shard, evict, or alert), and published back into the
timer database as ``DIST/host{h}::step`` timers so distributed health appears
in the Fig.-2-style report next to every other profile row.

Acting on stragglers (rebalance / evict) lives one layer up in
:mod:`repro_torch.adapt.stragglers`; this module supplies the two mechanisms that
make acting possible: the transport (so every host feeds the reduction, not
just host 0) and :meth:`StragglerDetector.evict` (so a removed host drops out
of the fleet median while its history stays visible in the report).
"""

from __future__ import annotations

import threading
from collections import deque
from collections.abc import Callable
from dataclasses import dataclass

from ..core.timers import TimerDB, timer_db

__all__ = ["LocalTransport", "StragglerDetector", "StragglerReport"]


class LocalTransport:
    """In-process step-time all-gather — the injectable reduction feed.

    Replaces the host-0-only feed: every host (real process or simulated
    participant) calls :meth:`publish` with its step walltime, and the reducing
    side calls :meth:`gather` to drain everyone's pending samples.  Real
    multi-process deployments implement the same two-call surface over an
    actual collective (a ``torch.distributed`` all-gather or a sidecar KV
    store); the in-process version makes the full measure→decide→migrate loop
    testable on one CPU.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict[int, list[float]] = {}
        self._dropped: set[int] = set()

    def publish(self, host: int, seconds: float) -> None:
        """Record one step walltime from ``host`` (dropped hosts are ignored)."""
        with self._lock:
            if host in self._dropped:
                return
            self._pending.setdefault(host, []).append(float(seconds))

    def gather(self) -> dict[int, list[float]]:
        """Drain and return all pending samples, keyed by host."""
        with self._lock:
            out, self._pending = self._pending, {}
        return out

    def drop_host(self, host: int) -> None:
        """Stop accepting samples from ``host`` (eviction path)."""
        with self._lock:
            self._dropped.add(host)
            self._pending.pop(host, None)

    @property
    def dropped(self) -> frozenset:
        with self._lock:
            return frozenset(self._dropped)


@dataclass(frozen=True)
class StragglerReport:
    """One fleet-health snapshot produced by :meth:`StragglerDetector.check`."""

    step: int
    #: windowed mean step-seconds per host (only active hosts with observations)
    host_means: dict[int, float]
    #: median of ``host_means`` values — the fleet's "normal" step time
    median: float
    #: hosts whose mean exceeds ``threshold * median``
    stragglers: list[int]
    threshold: float

    def slowdown(self, host: int) -> float:
        """How many x slower than the fleet median ``host`` is."""
        if self.median <= 0.0 or host not in self.host_means:
            return 0.0
        return self.host_means[host] / self.median


class StragglerDetector:
    """Windowed cross-host step-time reduction with median-ratio flagging.

    Parameters
    ----------
    n_hosts:
        Number of hosts expected to report (hosts are dense ints ``0..n-1``).
    window:
        Number of most-recent observations per host entering the mean.
    threshold:
        A host is a straggler when ``mean > threshold * median(all means)``.
    on_straggler:
        Called with the :class:`StragglerReport` whenever a check flags at
        least one host.
    publish:
        When true (default), each :meth:`check` mirrors per-host totals into
        the timer database as ``DIST/host{h}::step`` rows.
    transport:
        Optional :class:`LocalTransport`-shaped feed.  When set, every
        :meth:`check` (or an explicit :meth:`drain_transport`) first gathers
        and records all hosts' published step times — the multi-process
        reduction path.
    """

    def __init__(
        self,
        n_hosts: int,
        window: int = 32,
        threshold: float = 2.0,
        on_straggler: Callable[[StragglerReport], None] | None = None,
        publish: bool = True,
        db: TimerDB | None = None,
        transport: LocalTransport | None = None,
    ) -> None:
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if threshold <= 1.0:
            raise ValueError(f"threshold must exceed 1.0, got {threshold}")
        self.n_hosts = n_hosts
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.publish = publish
        self.transport = transport
        self._db = db
        self._windows: list[deque[float]] = [deque(maxlen=window) for _ in range(n_hosts)]
        self._totals: list[float] = [0.0] * n_hosts
        self._counts: list[int] = [0] * n_hosts
        #: (cumulative seconds, cumulative count) last sampled per db timer
        self._timer_marks: dict[tuple[int, str], tuple[float, int]] = {}
        self.reports: list[StragglerReport] = []
        #: hosts removed from the fleet by :meth:`evict` — kept in
        #: :meth:`host_stats` history but excluded from means and flagging
        self.evicted: set[int] = set()

    # -- feeding observations --------------------------------------------------
    def _record(self, host: int, mean_seconds: float, total: float, windows: int) -> None:
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} out of range [0, {self.n_hosts})")
        if host in self.evicted:  # late samples from a removed host
            return
        self._windows[host].append(float(mean_seconds))
        self._totals[host] += float(total)
        self._counts[host] += windows

    def observe(self, host: int, seconds: float) -> None:
        """Record one step walltime for ``host``."""
        self._record(host, seconds, seconds, 1)

    def drain_transport(self) -> int:
        """Gather and record every host's published step times; returns the
        number of samples recorded.  No-op without a transport."""
        if self.transport is None:
            return 0
        n = 0
        for host, samples in self.transport.gather().items():
            if not 0 <= host < self.n_hosts or host in self.evicted:
                continue
            for seconds in samples:
                self._record(host, seconds, seconds, 1)
                n += 1
        return n

    def observe_timer(self, host: int, timer_name: str, db: TimerDB | None = None) -> None:
        """Sample ``host``'s step time out of the timer database.

        Reads the named timer's cumulative walltime and window count, and
        observes the *mean seconds per window since the last sample* — the
        cross-process reduction path: each host ships its timer-DB readings and
        the detector diffs them, so instrumented code needs no extra hooks.
        Samplers sparser than one call per step stay exact: the full delta
        (all elapsed windows and seconds) is credited to :meth:`host_stats`,
        while the windowed mean enters the straggler comparison once.
        """
        db = db or self._db or timer_db()
        if not db.exists(timer_name):
            return
        timer = db.get(timer_name)
        # seconds() is the single-channel fast read off the flat accumulator
        # and stays correct when a collision namespaces the walltime channel
        seconds, count = timer.seconds(), timer.count
        last_seconds, last_count = self._timer_marks.get((host, timer_name), (0.0, 0))
        d_count = count - last_count
        if d_count > 0:
            delta = seconds - last_seconds
            self._record(host, delta / d_count, delta, d_count)
            self._timer_marks[(host, timer_name)] = (seconds, count)

    # -- membership -------------------------------------------------------------
    def add_host(self, host: int) -> None:
        """Grow the fleet to include ``host`` (elastic membership: a mid-run
        join).  Hosts stay dense ints; growing to ``host`` allocates empty
        windows for any ids in between.  Re-adding a previously evicted id is
        rejected — a rejoining physical node takes a fresh id, so its stale
        history can never pollute the new incarnation's judgment."""
        host = int(host)
        if host < 0:
            raise ValueError(f"host must be >= 0, got {host}")
        if host in self.evicted:
            raise ValueError(
                f"host {host} was evicted; rejoin under a fresh host id"
            )
        while self.n_hosts <= host:
            self._windows.append(deque(maxlen=self.window))
            self._totals.append(0.0)
            self._counts.append(0)
            self.n_hosts += 1

    def evict(self, host: int) -> None:
        """Remove ``host`` from the fleet (the straggler-response eviction
        path): its window is cleared, future samples are dropped, and it no
        longer enters the median or gets flagged.  Its cumulative
        :meth:`host_stats` history stays visible in the report."""
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} out of range [0, {self.n_hosts})")
        active = [h for h in range(self.n_hosts) if h not in self.evicted]
        if host not in self.evicted and len(active) <= 1:
            raise ValueError("cannot evict the last active host")
        self.evicted.add(host)
        self._windows[host].clear()
        if self.transport is not None:
            self.transport.drop_host(host)

    def active_hosts(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self.evicted]

    def reset_window(self, host: int) -> None:
        """Clear ``host``'s windowed samples (cumulative history stays).

        Call after the host's work assignment changes (e.g. a microbatch
        rebalance): samples measured under the old assignment no longer
        describe the host's current speed, and leaving them in the window
        makes a just-fixed host look slow for ``window`` more checks —
        compounding derates and, at the weight floor, spurious eviction.
        """
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} out of range [0, {self.n_hosts})")
        self._windows[host].clear()

    # -- queries ----------------------------------------------------------------
    def host_stats(self) -> dict[int, tuple[int, float]]:
        """{host: (n_observations, total_seconds)} over the whole run (hosts
        with at least one observation only; evicted hosts keep their history)."""
        return {
            host: (self._counts[host], self._totals[host])
            for host in range(self.n_hosts)
            if self._counts[host] > 0
        }

    def host_means(self) -> dict[int, float]:
        """Windowed mean step-seconds per active host (hosts with data only)."""
        return {
            host: sum(w) / len(w)
            for host, w in enumerate(self._windows)
            if len(w) > 0 and host not in self.evicted
        }

    def check(self, step: int) -> StragglerReport:
        """Reduce current windows into a report; flag, callback, and publish.

        Drains the transport first (when one is injected), so a bare
        ``check()`` on the reducing host sees every host's latest samples.
        """
        self.drain_transport()
        means = self.host_means()
        median = _median(list(means.values())) if means else 0.0
        stragglers = sorted(
            host
            for host, mean in means.items()
            if median > 0.0 and mean > self.threshold * median
        )
        report = StragglerReport(
            step=step,
            host_means=means,
            median=median,
            stragglers=stragglers,
            threshold=self.threshold,
        )
        self.reports.append(report)
        if self.publish:
            self.publish_to_db(self._db or timer_db())
        if stragglers and self.on_straggler is not None:
            self.on_straggler(report)
        return report

    def publish_to_db(self, db: TimerDB, prefix: str = "DIST") -> None:
        """Mirror per-host totals into ``{prefix}/host{h}::step`` timer rows.

        Uses the timer ``set_channel`` API (Cactus ``CCTK_TimerSet`` analogue),
        so the fleet-health rows render in ``core.report.format_report``
        exactly like locally measured timers.  Rows are resolved through the
        database's cached scope handles (the ``repro_torch.timing`` path→timer
        resolution), so repeated publishes skip the locked create/lookup.
        """
        from ..core.timers import TimerError

        for host, (count, total) in self.host_stats().items():
            timer = db.scope_handle(f"{prefix}/host{host}::step").timer
            try:
                timer.set_channel("walltime", total)
            except TimerError:  # no walltime clock registered: count-only row
                pass
            timer.count = count


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2 == 1:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])
