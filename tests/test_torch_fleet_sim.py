"""PyTorch port, the simulated fleet (``repro_torch.adapt.SimulatedFleet``):
the reference's fleet cases (``tests/test_adapt.py``: rebalance then evict
with a mesh rebuild, fresh-sample judging, transient slowdowns restored,
rounding sheds, restage of a slow stage owner, the checkpoint-before-evict
barrier), the port's decision log and final weights against the JAX
``SimulatedFleet`` under seeded fault plans (data-parallel and pipeline
fleets, ``run_pipeline=False``), and ``run_pipeline=True`` computing on the
CPU in both of its modes (``gpipe_forward`` per host; the 1F1B stage
pipeline with the restaged mask).
"""

import pytest
import torch

from repro.adapt import ControlLoop as JaxControlLoop
from repro.adapt.fleet import SimulatedFleet as JaxSimulatedFleet
from repro.core.timers import TimerDB as JaxTimerDB
from repro.faults.inject import apply_fleet_event as jax_apply_fleet_event
from repro.faults.plan import FaultPlan as JaxFaultPlan
from repro_torch.adapt import CheckpointControl, ControlLoop, SimulatedFleet
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import adapt_rows, format_report, straggler_rows
from repro_torch.core.adaptive import AdaptiveCheckpointPolicy
from repro_torch.core.timers import TimerDB
from repro_torch.dist import pipeline as pipeline_mod
from repro_torch.faults import FLEET_FAULTS, FaultPlan, apply_fleet_event


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


def _fleet(*args, **kw):
    db = TimerDB()
    fleet = SimulatedFleet(*args, db=db, device="cpu", **kw)
    loop = ControlLoop(db)
    loop.register(fleet.controller)
    return db, fleet, loop


def _drive(fleet, loop, steps):
    for step in steps:
        fleet.run_step(step)
        loop.poll(step)


# ---------------------------------------------------------------------------
# The reference's fleet cases
# ---------------------------------------------------------------------------


def test_fleet_rebalance_reduces_spread_then_eviction_recovers():
    db, fleet, loop = _fleet(4, 16, window=2, threshold=1.3, check_every=1,
                             confirm_after=1, evict_after=6, min_weight=0.2)
    assert fleet.plan.shares()[2] == 4
    fleet.slow_host(2, 2.0)
    fleet.run_step(0)
    spread_before = fleet.spread()
    for step in range(6):
        if step:
            fleet.run_step(step)
        loop.poll(step)
    fleet.run_step(6)
    rebalances = [a for a in loop.actions if a.action == "rebalance"]
    assert rebalances and rebalances[0].detail["host"] == 2
    assert fleet.plan.shares()[2] < 4 and 2 in fleet.active_hosts()
    assert fleet.spread() <= 0.5 * spread_before

    fleet.slow_host(2, 8.0)
    step, degraded = 7, 0.0
    while 2 in fleet.active_hosts() and step < 20:
        fleet.run_step(step)
        degraded = max(degraded, fleet.spread())
        loop.poll(step)
        step += 1
    evictions = [a for a in loop.actions if a.action == "evict"]
    assert len(evictions) == 1 and evictions[0].detail["host"] == 2
    assert fleet.active_hosts() == [0, 1, 3]
    assert fleet.mesh_generation == 1 and set(fleet.meshes) == {0, 1, 3}
    assert all(m.shape == {"pod": 1} for m in fleet.meshes.values())
    assert sum(fleet.plan.shares().values()) == 16
    fleet.run_step(step)
    assert fleet.spread() <= max(fleet.costs.values()) + 1e-9
    assert fleet.spread() < 0.1 * degraded
    rows = adapt_rows(loop)
    assert rows[-1]["action"] == "evict"
    assert all(r["action"] in ("rebalance", "restore") for r in rows[:-1])
    assert all(r["trigger"] == "DIST/host2::step" for r in rows)
    text = format_report(db, adapt=loop)
    assert "ADAPT/stragglers::rebalance" in text and "ADAPT/stragglers::evict" in text
    assert any("host2::step [EVICTED]" in r["timer"] for r in straggler_rows(fleet.detector))


def test_fleet_runs_real_pipeline_with_rebalanced_shares(monkeypatch):
    """run_pipeline=True pushes each host's share through gpipe_forward on
    its local CPU mesh, before and after a rebalance."""
    calls = []
    gpipe = pipeline_mod.gpipe_forward

    def spy(*args, **kw):
        out = gpipe(*args, **kw)
        calls.append((kw["n_micro"], tuple(out.shape), out.device.type))
        return out

    monkeypatch.setattr("repro_torch.adapt.fleet.gpipe_forward", spy)
    _, fleet, loop = _fleet(3, 9, window=2, threshold=1.3, check_every=1,
                            min_weight=0.2, run_pipeline=True)
    fleet.slow_host(1, 2.0)
    _drive(fleet, loop, range(3))
    assert fleet.plan.shares()[1] < 3
    assert calls[:3] == [(3, (6, 4), "cpu")] * 3
    assert (fleet.plan.shares()[1], (2 * fleet.plan.shares()[1], 4), "cpu") in calls[-3:]


def test_rebalanced_host_judged_on_fresh_samples_not_evicted():
    _, fleet, loop = _fleet(4, 16, window=4, threshold=1.2, check_every=1,
                            confirm_after=1, evict_after=4, min_weight=0.4)
    fleet.slow_host(2, 2.0)
    _drive(fleet, loop, range(16))
    assert 2 in fleet.active_hosts()
    assert not [a for a in loop.actions if a.action == "evict"]
    assert abs(fleet.plan.weights[2] - 0.5) < 0.15
    seconds = fleet.run_step(16)
    assert seconds[2] <= 1.2 * sorted(seconds.values())[len(seconds) // 2]


def test_transient_slowdown_recovers_full_weight():
    _, fleet, loop = _fleet(4, 16, window=2, threshold=1.3, check_every=1,
                            confirm_after=1, evict_after=8, min_weight=0.25)
    fleet.slow_host(1, 3.0)
    _drive(fleet, loop, range(5))
    assert fleet.plan.weights[1] < 0.5 and fleet.plan.shares()[1] < 4
    fleet.slow_host(1, 1 / 3.0)
    _drive(fleet, loop, range(5, 20))
    assert [a for a in loop.actions if a.action == "restore"]
    assert fleet.plan.weights[1] > 0.8 and fleet.plan.shares()[1] == 4
    assert 1 in fleet.active_hosts()


def test_rounding_extra_microbatch_shed_instead_of_eviction():
    _, fleet, loop = _fleet(4, 16, window=4, threshold=1.2, check_every=1,
                            confirm_after=1, evict_after=4, min_weight=0.4)
    fleet.slow_host(2, 2.0)
    _drive(fleet, loop, range(16))
    assert 2 in fleet.active_hosts()
    assert not [a for a in loop.actions if a.action == "evict"]
    assert not [a for a in loop.actions if a.step >= 10]


def test_pipeline_fleet_restage_moves_stage_boundary(monkeypatch):
    """A straggler that owns a stage is answered by moving the stage
    boundary, and the restaged (uneven) boundaries really execute through
    the 1F1B PipelineStep on the CPU (``run_pipeline=True``)."""
    masks = []
    call = pipeline_mod.PipelineStep.__call__

    def spy(self, stage_params, x, targets, stage_mask=None, **kw):
        masks.append(stage_mask.tolist())
        loss, grads = call(self, stage_params, x, targets, stage_mask, **kw)
        assert torch.isfinite(loss) and not grads[~stage_mask].any()
        return loss, grads

    monkeypatch.setattr(pipeline_mod.PipelineStep, "__call__", spy)
    db, fleet, loop = _fleet(4, 8, window=2, threshold=1.3, check_every=1,
                             confirm_after=1, evict_after=8, n_layers=12, run_pipeline=True)
    assert fleet.stage_plan.depths() == {0: 3, 1: 3, 2: 3, 3: 3}
    fleet.slow_host(2, 2.5)
    fleet.run_step(0)
    before = fleet.last_step_seconds[2]
    for step in range(8):
        if step:
            fleet.run_step(step)
        loop.poll(step)
    fleet.run_step(8)
    restages = [a for a in loop.actions if a.action == "restage"]
    assert restages and restages[0].detail["host"] == 2 and restages[0].detail["stage"] == 2
    assert adapt_rows(loop)[0]["action"] == "restage"
    depths = fleet.stage_plan.depths()
    assert depths[2] < 3 and sum(depths.values()) == 12 and min(depths.values()) >= 1
    assert fleet.restages and fleet.restages[0][:2] == (2, 2)
    assert fleet.last_step_seconds[2] < before and 2 in fleet.active_hosts()
    assert db.exists("ADAPT/stragglers::restage")
    assert "ADAPT/stragglers::restage" in format_report(db, adapt=loop)
    # the last step ran the restaged split's padded slot mask
    assert masks[-1] == fleet.stage_plan.pack(torch.zeros(12))[1].tolist() != masks[0]
    assert len(masks) == 9  # one 1F1B step a fleet step


def test_transient_stage_slowdown_restores_layers():
    _, fleet, loop = _fleet(4, 8, window=2, threshold=1.3, check_every=1,
                            confirm_after=1, evict_after=10, n_layers=12)
    fleet.slow_host(2, 2.5)
    _drive(fleet, loop, range(6))
    assert fleet.stage_plan.depths()[2] < 3
    fleet.slow_host(2, 1 / 2.5)
    _drive(fleet, loop, range(6, 20))
    restores = [a for a in loop.actions if a.action == "restore"]
    assert restores and restores[0].detail["host"] == 2
    assert fleet.stage_plan.depths() == {0: 3, 1: 3, 2: 3, 3: 3}
    assert any(r[0] == 2 and r[2][2] == 3 for r in fleet.restages)


def test_pipeline_fleet_unequal_shares_only_real_straggler_acted_on():
    _, fleet, loop = _fleet(4, 8, window=2, threshold=1.3, check_every=1,
                            confirm_after=1, evict_after=8, n_layers=12)
    fleet.plan.set_weight(3, 0.4)
    fleet.slow_host(2, 2.5)
    _drive(fleet, loop, range(8))
    rows = adapt_rows(loop)
    assert rows and {r["detail"]["host"] for r in rows} == {2}
    assert all(r["action"] == "restage" for r in rows)
    assert fleet.stage_plan.depths()[2] < 3


def _drive_to_eviction(fleet, loop, host, max_steps=20):
    fleet.slow_host(host, 8.0)
    step = 0
    while host in fleet.active_hosts() and step < max_steps:
        fleet.run_step(step)
        loop.poll(step)
        step += 1
    return step


def _barrier_fleet():
    return _fleet(3, 9, window=2, threshold=1.3, confirm_after=1, evict_after=3,
                  min_weight=0.5)


def test_checkpoint_before_evict_barrier_precedes_eviction(tmp_path):
    db, fleet, loop = _barrier_fleet()
    manager = CheckpointManager(str(tmp_path), synchronous=True)
    ctrl = CheckpointControl(AdaptiveCheckpointPolicy(mode="adaptive"))
    ctrl.start_run(0.0)

    def durable_save(step):
        manager.save(step, {"w": torch.tensor([float(step)])})
        manager.wait()
        return 0.01

    ctrl.bind_durable_save(durable_save)
    fleet.controller.evict_barrier = ctrl.evict_barrier
    _drive_to_eviction(fleet, loop, 2)
    assert 2 not in fleet.active_hosts()
    kinds = [(a.controller, a.action) for a in loop.actions]
    assert kinds[kinds.index(("stragglers", "evict")) - 1] == ("checkpoint", "before_evict")
    assert manager.checkpoints() and ctrl.barrier_saves == 1
    assert "ADAPT/checkpoint::before_evict" in format_report(db, adapt=loop)
    manager.close()


def test_failed_barrier_defers_eviction_until_save_succeeds():
    _, fleet, loop = _barrier_fleet()
    ctrl = CheckpointControl(AdaptiveCheckpointPolicy(mode="adaptive"))
    ctrl.start_run(0.0)
    ctrl.bind_durable_save(lambda step: (_ for _ in ()).throw(OSError("disk full")))
    fleet.controller.evict_barrier = ctrl.evict_barrier
    step = _drive_to_eviction(fleet, loop, 2, max_steps=12)
    assert 2 in fleet.active_hosts()
    assert fleet.controller.deferred_evictions >= 1 and ctrl.barrier_failures >= 1
    assert not [a for a in loop.actions if a.action == "evict"]
    ctrl.bind_durable_save(lambda s: 0.01)
    while 2 in fleet.active_hosts() and step < 30:
        fleet.run_step(step)
        loop.poll(step)
        step += 1
    assert 2 not in fleet.active_hosts()
    kinds = [(a.controller, a.action) for a in loop.actions]
    assert kinds.index(("checkpoint", "before_evict")) + 1 == kinds.index(("stragglers", "evict"))


def test_unbarriered_response_keeps_prior_semantics():
    _, fleet, loop = _barrier_fleet()
    _drive_to_eviction(fleet, loop, 2)
    assert 2 not in fleet.active_hosts()
    assert fleet.controller.deferred_evictions == 0
    assert not [a for a in loop.actions if a.controller == "checkpoint"]


# ---------------------------------------------------------------------------
# Seeded fault plans: the port's decisions are the reference's
# ---------------------------------------------------------------------------


def _run_drill(fleet, loop, plan, apply, steps):
    for step in range(steps):
        for event in plan.at(step):
            if event.target in fleet.costs:
                apply(event, fleet)
        fleet.run_step(step)
        loop.poll(step)
    log = [(a.step, a.controller, a.action, a.detail.get("host"), a.detail.get("stage"))
           for a in loop.actions]
    stage = fleet.stage_plan
    return (log, dict(fleet.plan.weights), stage and dict(stage.weights),
            stage and stage.depths(), list(fleet.evicted), dict(fleet.last_step_seconds),
            fleet.mesh_generation)


@pytest.mark.parametrize("n_layers", [0, 12], ids=["data-parallel", "pipeline"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_fault_plan_decisions_match_the_reference(seed, n_layers):
    steps, kw = 80, dict(window=4, threshold=1.5, evict_after=6, n_layers=n_layers)
    plan = FaultPlan.random(seed, steps * 3 // 4, kinds=FLEET_FAULTS, rate=0.05,
                            hosts=range(4))
    plan_j = JaxFaultPlan.random(seed, steps * 3 // 4, kinds=FLEET_FAULTS, rate=0.05,
                                 hosts=range(4))
    assert plan.describe() == plan_j.describe() and len(plan) > 0
    db = TimerDB()
    fleet = SimulatedFleet(4, 8, db=db, device="cpu", **kw)
    loop = ControlLoop(db)
    loop.register(fleet.controller)
    db_j = JaxTimerDB()
    fleet_j = JaxSimulatedFleet(4, 8, db=db_j, **kw)
    loop_j = JaxControlLoop(db_j)
    loop_j.register(fleet_j.controller)
    got = _run_drill(fleet, loop, plan, apply_fleet_event, steps)
    want = _run_drill(fleet_j, loop_j, plan_j, jax_apply_fleet_event, steps)
    assert got == want
    assert got[0], "the plan's faults drew no decision"
