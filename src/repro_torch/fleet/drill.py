"""Nightly fleet drill: seeded process-fault matrix against real ranks.

``python -m repro_torch.fleet.drill --seeds 3`` draws a deterministic
:class:`~repro_torch.faults.plan.FaultPlan` over the rank-fault kinds
(``kill_rank`` / ``hang_rank`` / ``rejoin_rank`` / ``slow_rank``), maps it
onto the launcher's event script, runs a real multi-process fleet per seed,
and asserts the contract that makes elasticity trustworthy:

* every rank exits cleanly (``done``) or discovers its own eviction
  (``fenced``) — no rank ever wedges or crashes;
* the soak invariants hold on the scraped metrics pages: valid expositions,
  counters never regress, the membership epoch never regresses, every ADAPT
  action is wire-visible, cardinality stays bounded;
* the membership epoch accounts for every transition: it ends at exactly
  ``1 + joins + leaves + straggler evicts``;
* any fault drawn at all must leave at least one ``ADAPT/fleet::*`` or
  straggler row in the journal — a drill that injects faults and records no
  adaptation is a silent failure, not a pass.

Faults are clamped to the first half of the run so the steady-tail
cardinality invariant has a settled tail to check.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from ..faults.plan import RANK_FAULTS, FaultPlan
from ..monitor.promparse import parse_exposition
from ..soak.invariants import SnapshotRecord, check_snapshots
from .launch import FleetSettings, run_fleet

__all__ = ["drill_settings", "run_drill"]

#: statuses a rank may legitimately end a drill with
_OK_STATUSES = {"done", "fenced"}


def drill_settings(
    seed: int,
    *,
    hosts: int = 3,
    steps: int = 60,
    rate: float = 0.08,
) -> tuple[FleetSettings, FaultPlan]:
    """Draw the seeded fault plan and map it onto launcher events.

    ``rejoin_rank`` targets get a fresh host id (evicted ids never return —
    the detector enforces it); ``hang_rank`` schedules the matching SIGCONT a
    dozen polls later so the drill also exercises the stale-epoch fence: the
    resumed rank publishes with its pre-eviction epoch and must be rejected.
    """
    fault_window = max(steps // 2, 1)
    plan = FaultPlan.random(
        seed, fault_window, kinds=RANK_FAULTS, rate=rate, hosts=list(range(hosts))
    )
    settings = FleetSettings(
        hosts=hosts,
        steps=steps,
        liveness_timeout_s=0.8,
        poll_interval_s=0.1,
        seed=seed,
        snapshot_every=5,
    )
    next_id = hosts
    for event in plan:
        if event.kind == "kill_rank":
            settings.kill_at.append((event.step, event.target))
        elif event.kind == "hang_rank":
            settings.hang_at.append((event.step, event.target))
            settings.cont_at.append(
                (min(event.step + 12, steps - 1), event.target)
            )
        elif event.kind == "rejoin_rank":
            settings.join_at.append((event.step, next_id))
            next_id += 1
        elif event.kind == "slow_rank":
            settings.slow_at.append((event.step, event.target, event.arg or 3.0))
    return settings, plan


def _check_invariants(summary: dict[str, Any], n_faults: int) -> list[str]:
    failures: list[str] = []

    records = []
    for i, snapshot in enumerate(summary["snapshots"]):
        record = SnapshotRecord(
            index=i,
            step=snapshot["step"],
            source="render",
            actions=dict(snapshot["actions"]),
        )
        try:
            record.exposition = parse_exposition(snapshot["exposition"])
        except ValueError as exc:
            record.parse_error = str(exc)
        records.append(record)
    failures.extend(check_snapshots(records))

    for host, final in sorted(summary["finals"].items()):
        if final.get("status") not in _OK_STATUSES:
            failures.append(
                f"rank {host} ended {final.get('status')!r} "
                f"(steps={final.get('steps')})"
            )

    counts = summary["action_counts"]
    evicts = counts.get("stragglers::evict", 0)
    expected_epoch = 1 + summary["joins_total"] + summary["leaves_total"] + evicts
    if summary["epoch"] != expected_epoch:
        failures.append(
            f"membership epoch {summary['epoch']} != 1 + joins "
            f"{summary['joins_total']} + leaves {summary['leaves_total']} "
            f"+ evicts {evicts}"
        )

    adaptive = sum(
        count
        for key, count in counts.items()
        if key.startswith("fleet::") or key.startswith("stragglers::")
    )
    if n_faults > 0 and adaptive == 0:
        failures.append(
            f"{n_faults} deterministic faults injected but the journal "
            "records no fleet/straggler action"
        )
    return failures


def run_drill(
    seed: int, *, hosts: int = 3, steps: int = 60, rate: float = 0.08
) -> dict[str, Any]:
    """One seeded drill; returns the journal plus its invariant failures."""
    settings, plan = drill_settings(seed, hosts=hosts, steps=steps, rate=rate)
    summary = run_fleet(settings)
    summary["seed"] = seed
    summary["fault_plan"] = plan.describe()
    # a slow_rank may legitimately stay under the flag threshold (and with
    # two hosts it mathematically must: the median includes the slow host),
    # so only the deterministic transitions demand a journal row
    deterministic = sum(
        1 for e in plan if e.kind in ("kill_rank", "hang_rank", "rejoin_rank")
    )
    summary["failures"] = _check_invariants(summary, deterministic)
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Seeded fleet fault drill")
    parser.add_argument("--seeds", type=int, default=3, help="seeds 0..N-1")
    parser.add_argument("--hosts", type=int, default=3)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--rate", type=float, default=0.08)
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    failed = 0
    for seed in range(args.seeds):
        result = run_drill(
            seed, hosts=args.hosts, steps=args.steps, rate=args.rate
        )
        status = "FAIL" if result["failures"] else "ok"
        failed += bool(result["failures"])
        if args.json:
            result.pop("snapshots", None)
            print(json.dumps(result, default=str))
        else:
            print(
                f"seed {seed}: {status} epoch={result['epoch']} "
                f"joins={result['joins_total']} leaves={result['leaves_total']} "
                f"defers={result['reshard_defers']} "
                f"stale_rejected={result['stale_rejected']} "
                f"faults=[{result['fault_plan'].replace(chr(10), '; ')}]"
            )
            for failure in result["failures"]:
                print(f"  FAIL: {failure}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
