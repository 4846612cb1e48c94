"""PyTorch port, the fleet layer (``repro_torch.fleet`` and
``repro_torch.soak.invariants``): the reference's unit cases
(``tests/test_fleet.py``: the rendezvous store's atomicity and log-offset
contracts, the epoch-fenced transport, elastic membership and its controller,
the payback gates, stage derivation, the straggler response's elastic hooks,
the wire view), then the port held against the JAX package on the same
inputs: byte-identical store directories, equal gathers under the fence,
equal payback decisions over a grid, equal membership records, epochs, plan
weights and ``ControlAction`` sequences under a fake clock, a numpy rank's
final loss bit for bit, and the drill's fault mapping and invariant checks.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.adapt.controller as j_controller
import repro.adapt.stragglers as j_stragglers
import repro.dist.pipeline as j_pipeline
import repro.dist.stragglers as j_dist_stragglers
import repro.fleet as j_fleet
import repro.fleet.drill as j_drill
import repro.monitor.export as j_export
import repro.monitor.promparse as j_promparse
import repro.soak.invariants as j_invariants
import repro_torch.adapt.controller as p_controller
import repro_torch.adapt.stragglers as p_stragglers
import repro_torch.dist.pipeline as p_pipeline
import repro_torch.dist.stragglers as p_dist_stragglers
import repro_torch.fleet as p_fleet
import repro_torch.fleet.drill as p_drill
import repro_torch.monitor.export as p_export
import repro_torch.monitor.promparse as p_promparse
import repro_torch.soak.invariants as p_invariants
from repro.core.timers import TimerDB as JaxTimerDB
from repro_torch.adapt.controller import ControlAction, ControlLoop
from repro_torch.adapt.stragglers import StragglerResponse
from repro_torch.core.timers import TimerDB
from repro_torch.dist.pipeline import MicrobatchPlan, StagePlan
from repro_torch.dist.stragglers import StragglerDetector, StragglerReport
from repro_torch.fleet import (
    FleetController,
    FleetTransport,
    Membership,
    PaybackPolicy,
    ReshardCost,
)
from repro_torch.fleet.store import FileStore
from repro_torch.fleet.topology import data_parallel_rank, stage_for_host
from repro_torch.monitor.export import MetricsExporter
from repro_torch.monitor.promparse import parse_exposition
from repro_torch.monitor.server import MonitorServer
from repro_torch.soak.invariants import SnapshotRecord, check_snapshots

ROOT = Path(__file__).resolve().parents[1]


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


def _pkg(fleet, controller, stragglers, pipeline, dist_stragglers):
    """One package's fleet-layer classes, so a script runs on either."""
    return SimpleNamespace(
        FileStore=fleet.FileStore, FleetTransport=fleet.FleetTransport,
        Membership=fleet.Membership, FleetController=fleet.FleetController,
        PaybackPolicy=fleet.PaybackPolicy, ReshardCost=fleet.ReshardCost,
        ControlAction=controller.ControlAction,
        StragglerResponse=stragglers.StragglerResponse,
        MicrobatchPlan=pipeline.MicrobatchPlan,
        StragglerDetector=dist_stragglers.StragglerDetector,
        StragglerReport=dist_stragglers.StragglerReport,
    )


PORT = _pkg(p_fleet, p_controller, p_stragglers, p_pipeline, p_dist_stragglers)
REF = _pkg(j_fleet, j_controller, j_stragglers, j_pipeline, j_dist_stragglers)


# --- FileStore ----------------------------------------------------------------

def test_store_put_get_delete_roundtrip(tmp_path):
    store = FileStore(str(tmp_path))
    store.put("membership", {"epoch": 3})
    assert store.get("membership") == {"epoch": 3}
    store.put("membership", {"epoch": 4})  # atomic replace
    assert store.get("membership")["epoch"] == 4
    store.delete("membership")
    assert store.get("membership", default="gone") == "gone"
    store.delete("membership")  # idempotent


def test_store_rejects_traversal_keys(tmp_path):
    store = FileStore(str(tmp_path))
    for bad in ("../escape", "a//b", "/abs", "a/../b", ""):
        with pytest.raises(ValueError):
            store.put(bad, {})


def test_store_scan_one_level(tmp_path):
    store = FileStore(str(tmp_path))
    store.put("join/3", {"host": 3})
    store.put("join/7", {"host": 7})
    store.put("beat/3", {"t": 1.0})
    scanned = store.scan("join")
    assert sorted(scanned) == ["join/3", "join/7"]
    assert scanned["join/7"] == {"host": 7}
    assert store.scan("nonexistent") == {}


def test_store_log_offsets_consume_only_complete_lines(tmp_path):
    store = FileStore(str(tmp_path))
    store.append("samples/0", {"s": 1.0})
    store.append("samples/0", {"s": 2.0})
    records, offset = store.read_log("samples/0")
    assert [r["s"] for r in records] == [1.0, 2.0]
    # a torn (in-flight) append must stay in the file for the next read
    path = os.path.join(str(tmp_path), "samples", "0.jsonl")
    with open(path, "ab") as f:
        f.write(b'{"s": 3.0')  # no newline: mid-write
    records, offset2 = store.read_log("samples/0", offset)
    assert records == [] and offset2 == offset
    with open(path, "ab") as f:
        f.write(b"}\n")
    records, offset3 = store.read_log("samples/0", offset2)
    assert [r["s"] for r in records] == [3.0] and offset3 > offset2
    # undecodable complete lines are skipped, offset still advances
    with open(path, "ab") as f:
        f.write(b"not json\n")
    records, offset4 = store.read_log("samples/0", offset3)
    assert records == [] and offset4 > offset3


def test_store_logs_listing(tmp_path):
    store = FileStore(str(tmp_path))
    store.append("samples/0", {"s": 1.0})
    store.append("samples/2", {"s": 1.0})
    assert store.logs("samples") == ["samples/0", "samples/2"]
    assert store.logs("empty") == []


def _tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _store_script(pkg, root: Path):
    """Puts, replaces, deletes and appends, a torn line and a bad line; the
    ``read_log`` results and offsets along the way."""
    store = pkg.FileStore(str(root))
    store.put("membership", {"epoch": 1, "hosts": {"0": {"share": 4}}})
    store.put("join/3", {"host": 3, "pid": 11})
    store.put("join/7", {"host": 7})
    store.put("membership", {"epoch": 2, "hosts": {"0": {"share": 2}, "3": {"share": 2}}})
    store.delete("join/3")
    store.delete("missing")
    seen = []
    for value in (0.05, 0.25, 1e-9):
        store.append("samples/0", {"e": 1, "s": value})
    store.append("samples/12", {"e": 2, "s": 0.5})
    records, offset = store.read_log("samples/0")
    seen.append((records, offset))
    path = root / "samples" / "0.jsonl"
    with open(path, "ab") as f:
        f.write(b'{"e": 2, "s": 0.7')  # torn last line
    seen.append(store.read_log("samples/0", offset))
    with open(path, "ab") as f:
        f.write(b"}\nnot json\n")
    seen.append(store.read_log("samples/0", offset))
    seen.append(store.read_log("samples/missing", 5))
    seen.append((store.logs("samples"), sorted(store.scan("join")), store.get("membership")))
    return seen


def test_store_matches_the_reference_byte_for_byte(tmp_path):
    got = _store_script(PORT, tmp_path / "port")
    want = _store_script(REF, tmp_path / "ref")
    assert got == want
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "ref")
    assert len(_tree_bytes(tmp_path / "port")) == 4


# --- FleetTransport -----------------------------------------------------------

def _members(epoch, joined):
    return lambda: (epoch, dict(joined))


def test_transport_publish_gather_across_instances(tmp_path):
    store = FileStore(str(tmp_path))
    worker = FleetTransport(store, host=0)
    worker.epoch = 1
    controller = FleetTransport(store, members_fn=_members(1, {0: 1}))
    worker.publish(0, 0.05)
    worker.publish(0, 0.06)
    assert controller.gather() == {0: [0.05, 0.06]}
    assert controller.gather() == {}  # offsets advanced: nothing new
    worker.publish(0, 0.07)
    assert controller.gather() == {0: [0.07]}
    assert controller.stale_rejected == 0


def test_transport_epoch_fence_rejects_stale_and_foreign(tmp_path):
    store = FileStore(str(tmp_path))
    worker = FleetTransport(store, host=1)
    controller = FleetTransport(store, members_fn=_members(3, {1: 3}))
    worker.epoch = 2  # stamped before host 1's admission epoch
    worker.publish(1, 0.05)
    worker.epoch = 3
    worker.publish(1, 0.06)
    stranger = FleetTransport(store, host=9)
    stranger.epoch = 3
    stranger.publish(9, 0.04)  # not in membership at all
    assert controller.gather() == {1: [0.06]}
    assert controller.stale_rejected == 2


def test_transport_drop_host_fences_local(tmp_path):
    store = FileStore(str(tmp_path))
    worker = FleetTransport(store, host=0)
    worker.epoch = 1
    controller = FleetTransport(store, members_fn=_members(1, {0: 1}))
    controller.drop_host(0)
    worker.publish(0, 0.05)
    assert controller.gather() == {}
    assert controller.dropped == frozenset({0})
    assert controller.stale_rejected == 1


def test_transport_heartbeat_writes_beat_key(tmp_path):
    store = FileStore(str(tmp_path))
    worker = FleetTransport(store, host=4)
    worker.heartbeat()
    beat = store.get("beat/4")
    assert beat["pid"] == os.getpid() and beat["t"] > 0


def _transport_script(pkg, root: Path):
    """Publishes under changing epochs and memberships, foreign hosts, a
    dropped host and an unfenced gatherer; every gather and rejection count."""
    store = pkg.FileStore(str(root))
    view = {"epoch": 1, "joined": {0: 1, 1: 1}}
    fenced = pkg.FleetTransport(store, members_fn=lambda: (view["epoch"], dict(view["joined"])))
    workers = {h: pkg.FleetTransport(store, host=h) for h in (0, 1, 2, 9)}
    out = []

    def publish(host, epoch, seconds):
        workers[host].epoch = epoch
        workers[host].publish(host, seconds)

    publish(0, 1, 0.05)
    publish(1, 1, 0.06)
    publish(9, 1, 0.01)  # foreign
    out.append((fenced.gather(), fenced.stale_rejected))
    view.update(epoch=2, joined={0: 1, 1: 1, 2: 2})  # host 2 admitted at 2
    publish(2, 1, 0.3)  # stamped before its admission: stale
    publish(2, 2, 0.07)
    publish(0, 2, 0.04)
    out.append((fenced.gather(), fenced.stale_rejected))
    fenced.drop_host(1)
    publish(1, 2, 0.08)
    view.update(epoch=3, joined={0: 1, 2: 2})  # host 1 left at 3
    publish(1, 3, 0.09)
    publish(0, 3, 0.05)
    out.append((fenced.gather(), fenced.stale_rejected, sorted(fenced.dropped)))
    out.append((fenced.gather(), fenced.stale_rejected))
    # a transport with no membership view fences nothing
    open_view = pkg.FleetTransport(store)
    out.append((open_view.gather(), open_view.stale_rejected))
    return out


def test_transport_matches_the_reference(tmp_path):
    got = _transport_script(PORT, tmp_path / "port")
    assert got == _transport_script(REF, tmp_path / "ref")
    assert got[0] == ({0: [0.05], 1: [0.06]}, 1)
    assert got[2][1] == 4 and got[2][2] == [1]


# --- topology -----------------------------------------------------------------

def test_stage_for_host_contiguous_blocks():
    assert stage_for_host([0, 1, 2, 3], 2) == {0: 0, 1: 0, 2: 1, 3: 1}
    # sparse, unsorted ids: ownership follows sorted order
    assert stage_for_host([7, 2, 5], 3) == {2: 0, 5: 1, 7: 2}
    # fewer hosts than stages: each host owns its block's first stage
    assert stage_for_host([0, 1], 4) == {0: 0, 1: 2}
    # the single-host launcher case
    assert stage_for_host([0], 4) == {0: 0}
    assert stage_for_host([], 2) == {}
    assert stage_for_host([0, 1], 0) == {}


def test_stage_for_host_covers_all_stages_when_enough_hosts():
    for n_hosts in range(3, 9):
        for n_stages in range(1, n_hosts + 1):
            owned = set(stage_for_host(range(n_hosts), n_stages).values())
            assert owned == set(range(n_stages))


def test_data_parallel_rank_dense_and_stable():
    assert data_parallel_rank([7, 2, 5], 5) == 1
    assert data_parallel_rank([7, 2, 5], 7) == 2
    with pytest.raises(ValueError):
        data_parallel_rank([0, 1], 9)


# --- payback ------------------------------------------------------------------

def test_reshard_cost_from_baseline_and_fallback(tmp_path):
    cost = ReshardCost.from_baseline()  # committed baseline: measured values
    assert 0.0 < cost.save_s < 1.0 and 0.0 < cost.restore_s < 1.0
    missing = ReshardCost.from_baseline(str(tmp_path / "nope.json"))
    assert missing.save_s == ReshardCost().save_s  # conservative fallback
    custom = tmp_path / "b.json"
    custom.write_text(json.dumps({
        "rows": [{"name": "ckpt/save_sync", "us_per_call": 2_000_000.0}]
    }))
    assert ReshardCost.from_baseline(str(custom)).save_s == pytest.approx(2.0)


def test_reshard_cost_matches_the_reference(tmp_path):
    """The default path reaches the same baseline file; a missing file and a
    partial one give the same costs; observations fold in alike."""
    for path in (None, str(tmp_path / "nope.json")):
        got, want = PORT.ReshardCost.from_baseline(path), REF.ReshardCost.from_baseline(path)
        assert asdict(got) == asdict(want)
    assert asdict(PORT.ReshardCost.from_baseline()) != asdict(PORT.ReshardCost())
    partial = tmp_path / "p.json"
    partial.write_text(json.dumps({"rows": [
        {"name": "ckpt/restore_latest", "us_per_call": 1234.5},
        {"name": "ckpt/other", "us_per_call": 9.0}, {"name": "ckpt/save_sync"}]}))
    got, want = (pkg.ReshardCost.from_baseline(str(partial)) for pkg in (PORT, REF))
    assert asdict(got) == asdict(want)
    for cost in (got, want):
        cost.observe(save_s=0.02, restore_s=0.01)
        cost.observe(save_s=-1.0, restore_s=0.03)
    assert asdict(got) == asdict(want) and got.total() == want.total()


def test_reshard_cost_observe_ewma():
    cost = ReshardCost(save_s=1.0, restore_s=1.0, ewma=0.5)
    cost.observe(save_s=3.0)
    assert cost.save_s == pytest.approx(2.0)
    cost.observe(restore_s=0.0)  # non-positive observations are ignored
    assert cost.restore_s == pytest.approx(1.0)
    assert cost.total() == pytest.approx(3.0)


def _report(step, host_means, median, stragglers, pkg=PORT):
    return pkg.StragglerReport(
        step=step, host_means=host_means, median=median,
        stragglers=stragglers, threshold=2.0,
    )


def test_evict_gate_passes_when_win_covers_cost():
    policy = PaybackPolicy(
        ReshardCost(save_s=0.1, restore_s=0.1, rebuild_s=0.0),
        horizon_steps=10,
    )
    # host 2 wastes 0.08 s/step past the median: 0.8 s over the horizon > 0.2
    report = _report(5, {0: 0.02, 1: 0.02, 2: 0.10}, 0.02, [2])
    assert policy.evict_gate(5, 2, report, 5.0) is None
    assert policy.defers["evict"] == 0


def test_evict_gate_defers_and_logs_the_numbers():
    policy = PaybackPolicy(
        ReshardCost(save_s=1.0, restore_s=1.0), horizon_steps=10
    )
    report = _report(5, {0: 0.02, 1: 0.02, 2: 0.10}, 0.02, [2])
    action = policy.evict_gate(5, 2, report, 5.0)
    assert action is not None and action.action == "defer_reshard"
    assert action.controller == "fleet"
    assert action.detail["reason"] == "evict" and action.detail["host"] == 2
    assert action.detail["projected_win_s"] == pytest.approx(0.8)
    assert action.detail["reshard_cost_s"] == pytest.approx(2.0)
    assert policy.defers["evict"] == 1


def test_zero_horizon_defers_every_optional_move():
    policy = PaybackPolicy(ReshardCost(), horizon_steps=0, min_hosts=1)
    report = _report(1, {0: 0.01, 1: 5.0}, 0.01, [1])
    assert policy.evict_gate(1, 1, report, 500.0) is not None
    assert policy.join_gate(1, 9, n_active=2, mean_step_s=10.0) is not None
    assert policy.defers == {"evict": 1, "join": 1}
    with pytest.raises(ValueError):
        PaybackPolicy(ReshardCost(), horizon_steps=-1)


def test_join_gate_bypasses_below_min_hosts():
    policy = PaybackPolicy(ReshardCost(save_s=9.0), horizon_steps=0, min_hosts=2)
    # fleet below provisioned size: rebuilding, never speculative
    assert policy.join_gate(1, 5, n_active=1, mean_step_s=0.0) is None
    # at provisioned size the gate applies (horizon 0 always defers)
    assert policy.join_gate(1, 5, n_active=2, mean_step_s=1.0) is not None


def _gates(pkg):
    """Both gates over a grid of horizons, costs, slowdowns and fleet sizes:
    each decision as ``None`` or the defer action's fields and ``describe()``."""
    out = []
    means = {0: 0.02, 1: 0.021, 2: 0.02, 3: 0.35}
    for horizon in (0, 1, 10, 50):
        for save_s, restore_s, rebuild_s in ((0.006, 0.003, 0.0), (0.1, 0.1, 0.05),
                                             (2.0, 1.0, 0.5)):
            for min_hosts in (1, 3, 5):
                policy = pkg.PaybackPolicy(pkg.ReshardCost(save_s, restore_s, rebuild_s),
                                           horizon_steps=horizon, min_hosts=min_hosts)
                for host, slow in ((3, 0.35), (1, 0.021), (2, 0.02), (7, 1.0)):
                    report = _report(4, {**means, host: slow}, 0.0205, [host], pkg)
                    out.append(policy.evict_gate(4, host, report, slow / 0.0205))
                for n_active in (1, 2, 3, 4):
                    for mean_s in (0.0, 0.02, 0.5, 3.0):
                        out.append(policy.join_gate(6, 8, n_active, mean_s))
                out.append(dict(policy.defers))
    return [(asdict(a), a.describe()) if hasattr(a, "describe") else a for a in out]


def test_payback_gates_match_the_reference():
    got = _gates(PORT)
    assert got == _gates(REF)
    decisions = [g for g in got if not isinstance(g, dict)]
    assert any(g is None for g in decisions) and any(g is not None for g in decisions)


# --- Membership ---------------------------------------------------------------

def _membership(tmp_path, hosts=(0, 1), n_micro=8, **kw):
    store = FileStore(str(tmp_path))
    plan = MicrobatchPlan.equal(hosts, n_micro)
    return store, plan, Membership(store, plan, **kw)


def test_membership_publishes_record_on_init(tmp_path):
    store, plan, membership = _membership(tmp_path, n_stages=2)
    record = store.get("membership")
    assert record["epoch"] == 1 and record["n_micro"] == 8
    assert sorted(record["hosts"]) == ["0", "1"]
    assert record["hosts"]["0"]["share"] == 4
    assert record["hosts"]["1"]["stage"] == 1
    assert record["hosts"]["0"]["joined_epoch"] == 1


def test_membership_admit_grows_plan_in_place_and_fences(tmp_path):
    store, plan, membership = _membership(tmp_path)
    assert membership.admit(2) is True
    assert membership.epoch == 2 and membership.joined_epoch[2] == 2
    assert sorted(plan.weights) == [0, 1, 2]  # the shared object grew
    assert store.get("membership")["hosts"]["2"]["joined_epoch"] == 2
    # duplicate admit: idempotent, no epoch bump, no re-apportionment
    assert membership.admit(2) is False
    assert membership.epoch == 2


def test_membership_remove_bumps_epoch_and_clears_keys(tmp_path):
    store, plan, membership = _membership(tmp_path)
    store.put("beat/1", {"t": 1.0})
    store.put("join/1", {"host": 1})
    membership.remove(1)
    assert membership.hosts == [0] and membership.epoch == 2
    assert 1 not in membership.joined_epoch
    assert store.get("beat/1") is None and store.get("join/1") is None
    assert store.get("membership")["epoch"] == 2


def test_membership_expiry_from_fake_clock(tmp_path):
    now = [100.0]
    store, plan, membership = _membership(
        tmp_path, liveness_timeout=2.0, clock=lambda: now[0]
    )
    store.put("beat/0", {"t": 100.0})
    store.put("beat/1", {"t": 100.0})
    now[0] = 101.0
    assert membership.expired() == []
    now[0] = 103.5
    store.put("beat/0", {"t": 103.0})  # host 0 kept beating
    assert membership.expired() == [1]
    ages = membership.beat_ages()
    assert ages[0] == pytest.approx(0.5) and ages[1] == pytest.approx(3.5)


# --- FleetController ----------------------------------------------------------

def _fleet(tmp_path, hosts=(0, 1, 2), *, payback=None, barrier=None,
           liveness=2.0, clock=None, n_micro=9, pkg=PORT):
    now = [100.0]
    clock = clock or (lambda: now[0])
    store = pkg.FileStore(str(tmp_path))
    plan = pkg.MicrobatchPlan.equal(hosts, n_micro)
    membership = pkg.Membership(
        store, plan, liveness_timeout=liveness, clock=clock
    )
    transport = pkg.FleetTransport(store, members_fn=membership.members_fn)
    detector = pkg.StragglerDetector(
        len(hosts), window=4, threshold=2.0, publish=False, transport=transport
    )
    response = pkg.StragglerResponse(detector, plan, evict_after=3)
    controller = pkg.FleetController(
        membership, transport, response,
        payback=payback, evict_barrier=barrier, clock=clock,
    )
    for h in hosts:
        store.put(f"beat/{h}", {"t": clock()})
    return store, membership, transport, detector, response, controller, now


def test_controller_join_admits_and_registers(tmp_path):
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    store.put("join/3", {"host": 3})
    actions = fleet.control(1, {})
    assert [a.action for a in actions] == ["join"]
    assert actions[0].detail["host"] == 3 and actions[0].detail["epoch"] == 2
    assert fleet.joins_total == 1
    assert membership.hosts == [0, 1, 2, 3]
    assert detector.n_hosts == 4  # response grew the detector in lockstep
    assert store.get("join/3") is None  # request consumed
    assert "DIST/host3::step" in response.channels


def test_controller_duplicate_join_is_idempotent(tmp_path):
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    store.put("join/1", {"host": 1})  # already a member
    actions = fleet.control(1, {})
    assert actions == [] and fleet.joins_total == 0
    assert membership.epoch == 1  # no bump
    assert store.get("join/1") is None  # acked (consumed) anyway


def test_controller_join_deferred_by_payback_stays_pending(tmp_path):
    policy = PaybackPolicy(ReshardCost(save_s=9.0), horizon_steps=0, min_hosts=1)
    store, membership, transport, detector, response, fleet, now = _fleet(
        tmp_path, payback=policy
    )
    store.put("join/5", {"host": 5})
    actions = fleet.control(1, {})
    assert [a.action for a in actions] == ["defer_reshard"]
    assert membership.hosts == [0, 1, 2] and fleet.joins_total == 0
    assert store.get("join/5") is not None  # retried next poll
    # a later poll with the gate satisfied admits it
    fleet.payback = None
    actions = fleet.control(2, {})
    assert [a.action for a in actions] == ["join"]


def test_controller_leave_runs_barrier_then_removes(tmp_path):
    saves = []

    def barrier(step, report):
        saves.append(step)
        return ControlAction(step=step, controller="checkpoint",
                             trigger="ckpt", action="before_evict", detail={})

    store, membership, transport, detector, response, fleet, now = _fleet(
        tmp_path, barrier=barrier
    )
    now[0] = 110.0  # every beat is stale; only hosts 1 and 2 refreshed
    store.put("beat/1", {"t": 110.0})
    store.put("beat/2", {"t": 110.0})
    actions = fleet.control(7, {})
    assert [a.action for a in actions] == ["before_evict", "leave"]
    assert actions[1].detail == {
        "host": 0, "reason": "heartbeat_expired", "epoch": 2,
        "survivors": [1, 2],
    }
    assert saves == [7] and fleet.leaves_total == 1
    assert membership.hosts == [1, 2] and detector.n_hosts == 3
    assert 0 in detector.evicted


def test_controller_leave_deferred_by_barrier_veto(tmp_path):
    store, membership, transport, detector, response, fleet, now = _fleet(
        tmp_path, barrier=lambda step, report: None
    )
    now[0] = 110.0  # no member refreshed: every beat is past the timeout
    actions = fleet.control(3, {})
    assert actions == [] and fleet.leaves_total == 0
    assert fleet.deferred_leaves >= 1  # vetoed, retried next poll
    assert membership.hosts == [0, 1, 2]  # nothing removed yet
    # join processed during the in-flight (deferred) evict barrier: admitted
    store.put("join/7", {"host": 7})
    actions = fleet.control(4, {})
    assert "join" in [a.action for a in actions]
    assert 7 in membership.hosts


def test_controller_never_fences_out_last_host(tmp_path):
    store, membership, transport, detector, response, fleet, now = _fleet(
        tmp_path, hosts=(0,), n_micro=4
    )
    now[0] = 200.0  # far past every timeout
    actions = fleet.control(1, {})
    assert actions == [] and membership.hosts == [0]


def test_heartbeat_expiry_racing_a_publish(tmp_path):
    """A rank that publishes samples and then dies: the leave fences it, and
    samples it wrote before (or after) the removal never reach the means."""
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    worker = FleetTransport(store, host=0)
    worker.epoch = 1
    worker.publish(0, 0.05)  # in flight before the expiry is noticed
    now[0] = 110.0
    store.put("beat/1", {"t": 110.0})
    store.put("beat/2", {"t": 110.0})
    actions = fleet.control(9, {})
    assert [a.action for a in actions] == ["leave"]
    worker.publish(0, 0.06)  # zombie publish after removal
    detector.observe(1, 0.01)
    detector.observe(2, 0.01)
    report = detector.check(9)
    assert 0 not in report.host_means
    assert transport.stale_rejected >= 1  # the fence did the rejection
    assert membership.hosts == [1, 2]


def test_stale_epoch_rejected_after_rejoin_of_same_id_is_impossible(tmp_path):
    """Evicted ids never return (detector contract) — a stale incarnation's
    samples are rejected by the admission-epoch fence."""
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    now[0] = 110.0
    store.put("beat/1", {"t": 110.0})
    store.put("beat/2", {"t": 110.0})
    fleet.control(1, {})  # evicts host 0 at epoch 2
    with pytest.raises(ValueError):
        detector.add_host(0)  # the id is burned
    zombie = FleetTransport(store, host=0)
    zombie.epoch = 1  # its pre-eviction view
    zombie.publish(0, 0.5)
    assert transport.gather() == {}
    assert transport.stale_rejected == 1


def test_controller_on_the_control_loop_records_adapt_rows(tmp_path):
    db = TimerDB()
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    loop = ControlLoop(db)
    loop.register(fleet)
    store.put("join/3", {"host": 3})
    loop.poll(1)
    counts = loop.summary()["action_counts"]
    assert counts.get("fleet::join") == 1
    assert db.get("ADAPT/fleet::join").count == 1


def _controller_script(pkg, root: Path):
    """Scripted samples, joins, beats and expiries under a fake clock with a
    payback gate and a barrier that vetoes its first call; after each poll
    the actions, epoch, plan weights, published record and status payload."""
    now = [100.0]
    barrier_calls = []

    def barrier(step, report):
        barrier_calls.append(step)
        if len(barrier_calls) == 1:
            return None  # the save is not durable yet: veto
        return pkg.ControlAction(step=step, controller="checkpoint", trigger="ckpt",
                                 action="before_evict", detail={"call": len(barrier_calls)})

    payback = pkg.PaybackPolicy(pkg.ReshardCost(save_s=0.5, restore_s=0.5), horizon_steps=10,
                                min_hosts=3)
    store, membership, transport, detector, response, fleet, _ = _fleet(
        root, payback=payback, barrier=barrier, clock=lambda: now[0], pkg=pkg)
    workers = {h: pkg.FleetTransport(store, host=h) for h in range(6)}
    out = []

    def publish(seconds):
        for h in membership.hosts:
            workers[h].epoch = membership.epoch
            workers[h].publish(h, seconds[h] if isinstance(seconds, dict) else seconds)

    def beat(*hosts):
        for h in hosts:
            store.put(f"beat/{h}", {"t": now[0]})

    def poll(step):
        actions = fleet.control(step, {})
        detector.check(step)
        status = fleet.status_payload()
        record = store.get("membership")
        out.append(([(asdict(a), a.describe()) for a in actions], membership.epoch,
                    dict(membership.plan.weights), dict(membership.joined_epoch), record,
                    status, membership.pending_joins(), transport.stale_rejected))

    publish(0.05)
    store.put("join/3", {"host": 3})
    poll(1)  # no means yet: the join does not pay back its 1.0 s
    publish(0.6)
    poll(2)  # the means lag one poll: 0.05 / 4 x 10 < 1.0 s, deferred
    publish(0.9)
    poll(3)  # 0.325 / 4 x 10 < 1.0 s, still deferred
    store.put("join/1", {"host": 1})  # a duplicate of a present member
    store.put("join/x", {"host": "x"})  # unparseable: skipped
    beat(0, 1, 2, 3)
    poll(4)  # 0.517 / 4 x 10 > 1.0 s: admitted at epoch 2
    now[0] = 101.5
    beat(1, 2, 3)
    poll(5)  # nobody expired yet
    now[0] = 102.5
    beat(1, 2, 3)
    poll(6)  # host 0 expired: the barrier vetoes the leave
    publish({0: 0.05, 1: 0.05, 2: 0.05, 3: 0.05})
    poll(7)  # the barrier passes: host 0 leaves at epoch 3
    workers[0].epoch = 2
    workers[0].publish(0, 0.5)  # a zombie's sample: fenced
    now[0] = 110.0
    beat(3)
    poll(8)  # hosts 1 and 2 expired
    now[0] = 200.0
    poll(9)  # everyone expired: host 3 stays, the last host is never fenced
    out.append((barrier_calls, fleet.joins_total, fleet.leaves_total, fleet.deferred_leaves,
                dict(payback.defers), sorted(detector.evicted), detector.n_hosts))
    return out


def test_controller_matches_the_reference_under_a_fake_clock(tmp_path):
    got = _controller_script(PORT, tmp_path / "port")
    want = _controller_script(REF, tmp_path / "ref")
    assert got == want
    actions = [a[0]["action"] for poll in got[:-1] for a in poll[0]]
    assert actions == ["defer_reshard"] * 3 + ["join"] + ["before_evict", "leave"] * 3
    assert got[-1][1:5] == (1, 3, 1, {"evict": 0, "join": 3})
    assert got[-2][1] == 5 and list(got[-2][2]) == [3] and got[-2][7] == 2


# --- StragglerResponse elastic hooks ------------------------------------------

def _response(hosts=(0, 1, 2), n_micro=9, **kw):
    plan = MicrobatchPlan.equal(hosts, n_micro)
    detector = StragglerDetector(len(hosts), window=4, publish=False)
    return plan, detector, StragglerResponse(detector, plan, **kw)


def test_register_host_requires_plan_membership():
    plan, detector, response = _response()
    with pytest.raises(ValueError):
        response.register_host(3)  # not in the plan: grow the plan first
    grown = plan.retarget([0, 1, 2, 3])
    plan.weights.clear()
    plan.weights.update(grown.weights)
    response.register_host(3)
    assert detector.n_hosts == 4
    assert "DIST/host3::step" in response.channels


def test_register_host_with_stage_updates_stage_map():
    stage_plan = StagePlan.equal(range(2), 4)
    plan, detector, response = _response(
        stage_plan=stage_plan, stage_for_host={0: 0, 1: 1, 2: 1}
    )
    grown = plan.retarget([0, 1, 2, 3])
    plan.weights.clear()
    plan.weights.update(grown.weights)
    response.register_host(3, stage=1)
    assert response.stage_for_host[3] == 1


def test_remove_host_shrinks_plan_detector_and_stages():
    stage_plan = StagePlan.equal(range(2), 4)
    plan, detector, response = _response(
        stage_plan=stage_plan, stage_for_host={0: 0, 1: 1, 2: 1}
    )
    response.remove_host(2)
    assert sorted(plan.weights) == [0, 1]
    assert 2 in detector.evicted
    assert 2 not in response.stage_for_host
    assert sorted(stage_plan.weights) == [0, 1]  # stage 1 still owned by host 1
    response.remove_host(1)  # last owner of stage 1: the stage is orphaned
    assert sorted(stage_plan.weights) == [0]


def test_reshard_gate_defers_eviction_and_keeps_streak():
    deferred = []

    def gate(step, host, report, slowdown):
        deferred.append(host)
        return ControlAction(step=step, controller="fleet",
                             trigger=f"DIST/host{host}::step",
                             action="defer_reshard", detail={"host": host})

    plan, detector, response = _response(
        check_every=1, confirm_after=1, evict_after=2, min_weight=0.5,
        reshard_gate=gate,
    )
    for step in range(1, 8):
        for h in (0, 1):
            detector.observe(h, 0.01)
        detector.observe(2, 0.2)
        response.control(step, {})
    assert response.deferred_reshards >= 1
    assert deferred and set(deferred) == {2}
    assert 2 in plan.weights  # never actually evicted
    assert 2 not in detector.evicted


# --- the rank ---------------------------------------------------------------------

def _run_rank(tmp_path: Path, package: str) -> dict:
    """One rank of ``package`` with a fixed share of 4, 20 steps, seed 3, in
    a subprocess; its ``final/0`` record."""
    root = tmp_path / package
    store = FileStore(str(root))
    store.put("membership", {"epoch": 1, "n_micro": 4,
                             "hosts": {"0": {"weight": 1.0, "share": 4, "stage": None,
                                             "joined_epoch": 1}}})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.fleet.worker", "--root", str(root), "--host", "0",
         "--seed", "3", "--max-steps", "20", "--step-floor-s", "0"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return store.get("final/0")


def test_worker_loss_matches_the_reference_bit_for_bit(tmp_path):
    got, want = _run_rank(tmp_path, "repro_torch"), _run_rank(tmp_path, "repro")
    assert got["status"] == want["status"] == "done"
    assert got["steps"] == want["steps"] == 20 and got["epoch"] == want["epoch"] == 1
    assert got["loss"] == want["loss"]
    assert got["loss"] < 5.0  # 80 SGD micro-steps moved it off the start
    assert len(FileStore(str(tmp_path / "repro_torch")).read_log("samples/0")[0]) == 20


# --- the drill's mapping and invariants -----------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_drill_settings_match_the_reference(seed):
    (got, got_plan), (want, want_plan) = (mod.drill_settings(seed) for mod in (p_drill, j_drill))
    assert asdict(got) == asdict(want)
    assert got_plan.describe() == want_plan.describe()
    small = p_drill.drill_settings(seed, hosts=2, steps=24, rate=0.2)
    assert asdict(small[0]) == asdict(j_drill.drill_settings(seed, hosts=2, steps=24,
                                                             rate=0.2)[0])


def _drill_summary(tmp_path: Path) -> dict:
    """A drill journal built without processes: a fleet controller under a
    fake clock admits a join and fences a dead host, and its exporter's pages
    are the snapshots."""
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    db = TimerDB()
    loop = ControlLoop(db)
    loop.register(fleet)
    exporter = MetricsExporter(db, control_loop=loop, detector=detector,
                               fleet_fn=fleet.status_payload)
    snapshots = []

    def snap(step):
        snapshots.append({"step": step, "actions": dict(loop.summary()["action_counts"]),
                          "exposition": exporter.render()})

    snap(-1)
    for step in range(12):
        if step == 2:
            store.put("join/3", {"host": 3})
        now[0] += 0.5
        for h in membership.hosts:
            if h != 0 or step < 4:  # host 0 dies at step 4
                store.put(f"beat/{h}", {"t": now[0]})
        loop.poll(step)
        if step % 3 == 2:
            snap(step)
    snap(12)
    counts = loop.summary()["action_counts"]
    return {"snapshots": snapshots, "action_counts": counts, "epoch": membership.epoch,
            "joins_total": fleet.joins_total, "leaves_total": fleet.leaves_total,
            "finals": {"1": {"status": "done", "steps": 12}, "2": {"status": "fenced"},
                       "3": {"status": "done", "steps": 9}}}


def test_drill_invariant_checks_match_the_reference(tmp_path):
    summary = _drill_summary(tmp_path)
    assert summary["action_counts"] == {"fleet::join": 1, "fleet::leave": 1}
    variants = {"clean": summary}
    bad = json.loads(json.dumps(summary))
    bad["epoch"] = 5
    bad["finals"]["1"]["status"] = "admit_timeout"
    variants["epoch_and_status"] = bad
    quiet = json.loads(json.dumps(summary))
    quiet["action_counts"] = {}
    variants["no_adaptation"] = quiet
    torn = json.loads(json.dumps(summary))
    torn["snapshots"][2]["exposition"] += "repro_fleet_hosts{oops 1\n"
    torn["snapshots"][3]["actions"]["fleet::join"] = 2
    variants["torn_page"] = torn
    regressed = json.loads(json.dumps(summary))
    regressed["snapshots"][-1]["exposition"] = regressed["snapshots"][-1]["exposition"].replace(
        "repro_fleet_membership_epoch 3", "repro_fleet_membership_epoch 1")
    variants["epoch_regressed"] = regressed
    results = {}
    for name, variant in variants.items():
        for n_faults in (0, 2):
            got = p_drill._check_invariants(variant, n_faults)
            assert got == j_drill._check_invariants(variant, n_faults), (name, n_faults)
            results[name, n_faults] = got
    assert results["clean", 2] == []
    assert len(results["epoch_and_status", 0]) == 2
    assert results["no_adaptation", 0] == [] and len(results["no_adaptation", 2]) == 1
    assert any("malformed" in f for f in results["torn_page", 0])
    assert any("taken 2x" in f for f in results["torn_page", 0])
    assert any("epoch regressed 3 -> 1" in f for f in results["epoch_regressed", 0])


# --- wire views ---------------------------------------------------------------

def _wired(tmp_path):
    store, membership, transport, detector, response, fleet, now = _fleet(tmp_path)
    store.put("join/3", {"host": 3})
    fleet.control(1, {})
    return fleet


def test_status_payload_shape(tmp_path):
    fleet = _wired(tmp_path)
    payload = fleet.status_payload()
    assert payload["epoch"] == 2 and payload["joins_total"] == 1
    assert sorted(payload["hosts"]) == ["0", "1", "2", "3"]
    entry = payload["hosts"]["3"]
    assert entry["joined_epoch"] == 2 and entry["share"] >= 1
    assert payload["reshard_defers_total"] == 0
    assert payload["stale_samples_rejected"] == 0


def test_exporter_fleet_families_render_and_parse(tmp_path):
    fleet = _wired(tmp_path)
    exporter = MetricsExporter(TimerDB(), fleet_fn=fleet.status_payload)
    page = parse_exposition(exporter.render())
    assert page.value("repro_fleet_hosts") == 4.0
    assert page.value("repro_fleet_membership_epoch") == 2.0
    assert page.value("repro_fleet_joins_total") == 1.0
    assert page.value("repro_fleet_leaves_total") == 0.0
    assert page.value("repro_fleet_reshard_defers_total") == 0.0
    assert page.value("repro_fleet_stale_samples_total") == 0.0
    shares = page.series("repro_fleet_host_share")
    assert len(shares) == 4 and all(v >= 1.0 for v in shares.values())


def test_exporter_fleet_families_match_the_reference(tmp_path):
    """The port's and the reference's exporters render the two packages'
    fleet payloads (the same script) as the same ``repro_fleet_*`` series."""
    pages = []
    for name, pkg, export, promparse in (("port", PORT, p_export, p_promparse),
                                         ("ref", REF, j_export, j_promparse)):
        store, membership, transport, detector, response, fleet, now = _fleet(
            tmp_path / name, pkg=pkg)
        store.put("join/3", {"host": 3})
        fleet.control(1, {})
        now[0] = 110.0
        store.put("beat/3", {"t": 110.0})
        store.put("beat/2", {"t": 110.0})
        fleet.control(2, {})
        db = TimerDB() if pkg is PORT else JaxTimerDB()
        page = promparse.parse_exposition(
            export.MetricsExporter(db, fleet_fn=fleet.status_payload).render())
        pages.append({k: v for k, v in page.samples.items() if k[0].startswith("repro_fleet")})
    assert pages[0] == pages[1]
    assert pages[0][("repro_fleet_membership_epoch", ())] == 4.0


def test_monitor_fleet_endpoint(tmp_path):
    fleet = _wired(tmp_path)
    server = MonitorServer(port=0, db=TimerDB(), fleet_fn=fleet.status_payload)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}/fleet"
        with urllib.request.urlopen(url, timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["epoch"] == 2 and "3" in payload["hosts"]
    finally:
        server.stop()


def test_monitor_fleet_endpoint_404_when_unwired():
    server = MonitorServer(port=0, db=TimerDB())
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}/fleet"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url, timeout=5)
        assert err.value.code == 404
    finally:
        server.stop()


# --- soak invariant: membership epoch monotonicity -----------------------------

def _epoch_page(mono, epoch):
    return parse_exposition(
        "# TYPE repro_scrape_monotonic_seconds gauge\n"
        f"repro_scrape_monotonic_seconds {mono}\n"
        "# TYPE repro_fleet_membership_epoch gauge\n"
        f"repro_fleet_membership_epoch {epoch}\n"
    )


def _snaps(epochs):
    return [
        SnapshotRecord(index=i, step=i, source="render",
                       exposition=_epoch_page(float(i + 1), e))
        for i, e in enumerate(epochs)
    ]


def test_soak_epoch_monotonicity_passes_on_climb():
    failures = check_snapshots(_snaps([1, 1, 2, 4, 4]))
    assert not any("epoch" in f for f in failures)


def test_soak_epoch_monotonicity_trips_on_regression():
    failures = check_snapshots(_snaps([1, 3, 2]))
    assert any("membership epoch regressed 3 -> 2" in f for f in failures)


def test_soak_epoch_check_skips_pages_without_the_family():
    bare = parse_exposition(
        "# TYPE repro_scrape_monotonic_seconds gauge\n"
        "repro_scrape_monotonic_seconds 9.0\n"
    )
    snaps = _snaps([1, 5])
    snaps.append(SnapshotRecord(index=2, step=2, source="render", exposition=bare))
    failures = check_snapshots(snaps)
    assert not any("epoch" in f for f in failures)


@pytest.mark.parametrize("epochs", [[1, 1, 2, 4, 4], [1, 3, 2], [2, 1, 1, 3]])
def test_soak_epoch_checks_match_the_reference(epochs):
    def records(inv, promparse):
        text = ("# TYPE repro_scrape_monotonic_seconds gauge\n"
                "repro_scrape_monotonic_seconds {}\n"
                "# TYPE repro_fleet_membership_epoch gauge\n"
                "repro_fleet_membership_epoch {}\n")
        return [inv.SnapshotRecord(index=i, step=i, source="render",
                                   exposition=promparse.parse_exposition(text.format(i + 1, e)))
                for i, e in enumerate(epochs)]

    got = p_invariants.check_snapshots(records(p_invariants, p_promparse))
    assert got == j_invariants.check_snapshots(records(j_invariants, j_promparse))
