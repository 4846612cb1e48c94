"""PyTorch port, real multi-process fleets (``repro_torch.fleet.launch``):
the reference's tier-1 fleet smoke (``tests/test_fleet_launch.py``) with
real subprocess ranks over the rendezvous store.

* the elasticity smoke — 2 provisioned ranks, a SIGKILL, then a mid-run
  join: the kill is *detected* (heartbeat expiry, then a barrier-gated
  leave), the joiner earns share, every transition is an ``ADAPT/fleet::*``
  row, and the joins/leaves/epoch deltas are visible between the first and
  last scraped pages;
* the payback smoke — ``horizon_steps=0``, so the join is deferred every
  poll with the measured re-shard cost in the action detail and the epoch
  never moves;
* seeded drills — the drill's own invariant set over real ranks.

Steady by design, whatever the machine's load: where expiry is not what a
case tests, the liveness timeout leaves seconds of margin over the
heartbeat; the kill comes early and the join only after the kill's expiry
must have been seen (the fleet never holds three live ranks, so no rank can
be judged a straggler: a straggler's mean must exceed twice the median of
the others, which two ranks cannot show); every spawned rank has seconds to
start before it is needed; and nothing asserts a count that depends on how
the scheduler slices time.
"""

import numpy as np
import pytest

from repro_torch.fleet.drill import run_drill
from repro_torch.fleet.launch import FleetSettings, run_fleet
from repro_torch.monitor.promparse import parse_exposition
from repro_torch.soak.invariants import SnapshotRecord, check_snapshots


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's)."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    yield
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()


def _wire_value(snapshot, name):
    return parse_exposition(snapshot["exposition"]).value(name)


def test_two_rank_kill_and_join_smoke(tmp_path):
    # host 0 dies at poll 2; polls take at least poll_interval_s each, so by
    # poll 42 at least 4 s have passed, past its 2.5 s liveness timeout, and
    # that poll's fleet controller takes leaves before joins: the leave comes
    # first whatever the load, and the joiner spawned at poll 42 has 38 polls
    # (3.8 s or more) to start and ask
    settings = FleetSettings(
        hosts=2,
        steps=80,
        step_floor_s=0.02,
        poll_interval_s=0.1,
        liveness_timeout_s=2.5,
        snapshot_every=5,
        rendezvous=str(tmp_path / "rdzv"),
        kill_at=[(2, 0)],
        join_at=[(42, 2)],
    )
    summary = run_fleet(settings)

    # membership arithmetic: one kill-triggered leave, one join, each an epoch
    assert summary["joins_total"] == 1
    assert summary["leaves_total"] == 1
    assert summary["epoch"] == 3
    assert summary["hosts"] == [1, 2]
    # every survivor holds share; the whole microbatch budget stays assigned
    assert sorted(summary["shares"]) == [1, 2]
    assert sum(summary["shares"].values()) == settings.n_micro

    # the kill went through the checkpoint-before-evict barrier, then the join
    counts = summary["action_counts"]
    assert counts.get("fleet::join") == 1
    assert counts.get("fleet::leave") == 1
    assert counts.get("checkpoint::before_evict", 0) >= 1
    assert not any(key.startswith("stragglers::evict") for key in counts)
    assert summary["barrier_saves"] >= 1
    fleet_rows = [row for row in summary["actions"] if row.startswith("[fleet]")]
    assert [row.split(": ")[1].split()[0] for row in fleet_rows] == ["leave", "join"]
    assert "host=0 reason=heartbeat_expired epoch=2" in fleet_rows[0]
    assert "host=2 epoch=3" in fleet_rows[1]

    # ranks: the joiner and the survivor drained cleanly; the killed rank
    # never wrote a final record (SIGKILL leaves no goodbye)
    finals = summary["finals"]
    assert finals["1"]["status"] == "done" and finals["1"]["steps"] > 0
    assert finals["2"]["status"] == "done" and finals["2"]["steps"] > 0
    assert "0" not in finals

    # wire visibility: the joins/leaves/epoch transitions are Prometheus
    # deltas between the first and last scraped pages
    first, last = summary["snapshots"][0], summary["snapshots"][-1]
    assert _wire_value(first, "repro_fleet_joins_total") == 0.0
    assert _wire_value(last, "repro_fleet_joins_total") == 1.0
    assert _wire_value(first, "repro_fleet_leaves_total") == 0.0
    assert _wire_value(last, "repro_fleet_leaves_total") == 1.0
    assert _wire_value(first, "repro_fleet_membership_epoch") == 1.0
    assert _wire_value(last, "repro_fleet_membership_epoch") == 3.0
    assert _wire_value(last, "repro_fleet_hosts") == 2.0

    # and the full soak invariant set holds over the scraped sequence
    records = [
        SnapshotRecord(
            index=i, step=s["step"], source="render",
            actions=dict(s["actions"]),
            exposition=parse_exposition(s["exposition"]),
        )
        for i, s in enumerate(summary["snapshots"])
    ]
    assert check_snapshots(records) == []

    # the workers converged on the shared problem (they did real work)
    losses = [f["loss"] for f in finals.values()]
    assert all(np.isfinite(losses))


def test_zero_horizon_defers_join_with_measured_cost(tmp_path):
    # the joiner is spawned at the first poll and has 40 polls (4 s or more)
    # to ask; nobody is meant to expire, so the liveness timeout is longer
    # than the run
    settings = FleetSettings(
        hosts=2,
        steps=40,
        step_floor_s=0.02,
        poll_interval_s=0.1,
        liveness_timeout_s=30.0,
        horizon_steps=0,  # no payback horizon: every optional move defers
        snapshot_every=4,
        rendezvous=str(tmp_path / "rdzv"),
        join_at=[(0, 2)],
    )
    summary = run_fleet(settings)

    # the join request was gated every poll, never admitted
    assert summary["joins_total"] == 0
    assert summary["leaves_total"] == 0
    assert summary["epoch"] == 1
    assert summary["hosts"] == [0, 1]
    assert summary["reshard_defers"]["join"] >= 1
    assert summary["action_counts"].get("fleet::defer_reshard", 0) >= 1

    # the defer detail carries the measured (startup save+restore) cost
    defer_rows = [a for a in summary["actions"] if "defer_reshard" in a]
    assert defer_rows
    assert summary["reshard_cost_s"] > 0.0
    assert "reshard_cost_s=" in defer_rows[-1]
    assert "reason=join" in defer_rows[-1]

    # defers are wire-visible too
    assert _wire_value(
        summary["snapshots"][-1], "repro_fleet_reshard_defers_total"
    ) >= 1.0

    # both provisioned ranks drained cleanly; the gated joiner never got a
    # share and left on the shutdown key without a step
    finals = summary["finals"]
    assert finals["0"]["status"] == "done"
    assert finals["1"]["status"] == "done"
    assert finals["2"]["status"] == "done" and finals["2"]["steps"] == 0


@pytest.mark.parametrize("seed", [0, 2])
def test_seeded_drill_invariants_hold(seed):
    """Nightly-style drill seeds: the seeded rank-fault matrix (seed 0 draws
    no fault at 40 polls; seed 2 a rejoin then a kill) against real
    processes, checked by the drill's own invariant set, which holds however
    the load delays a heartbeat: the epoch accounts for every transition,
    every rank ends done or fenced, and the steady tail holds no poll."""
    result = run_drill(seed, hosts=3, steps=40)
    assert result["failures"] == []
    if seed == 2:  # the kill at poll 14 expires 0.8 s later, 2.6 s or more before the end
        assert result["action_counts"].get("fleet::leave", 0) >= 1
