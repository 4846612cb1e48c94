"""Nightly fault soak: train and adapt *through* injected failures, then
assert the system actually recovered.

Two drills, both deterministic from ``--seed``:

* **fleet drill** — a :class:`~repro_torch.adapt.fleet.SimulatedFleet` under a
  :class:`~repro_torch.adapt.controller.ControlLoop` takes a seeded
  :class:`~repro_torch.faults.plan.FaultPlan` of slow/hang/restore events.  After
  the run the fleet must be healthy again (imbalance back under the detector
  threshold, or the wedged host evicted) and — the timing-infrastructure
  invariant — the timer database and counter set must be *bounded*: a control
  loop that allocates a new timer or counter per step would eventually OOM a
  long-running application, so the steady-state tail of the run (after the
  last injected fault has settled) may create no new names.

* **checkpoint drill** — a short real training run checkpoints into a temp
  directory; the drill then corrupts the newest checkpoint, plants killed-
  writer debris, and resumes.  The resumed run must select the newest *valid*
  step, quarantine every damaged directory with a reason, and finish.

Both drills run on ``--device`` (default ``cuda``; there is no fallback to
the CPU).  Exit code is non-zero on any failed assertion — wire it as a
scheduled CI job:

    PYTHONPATH=src python -m repro_torch.faults.soak --seed 1 --steps 200
    PYTHONPATH=src python -m repro_torch.faults.soak --device cpu
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import tempfile

__all__ = ["fleet_drill", "checkpoint_drill", "main"]


class SoakFailure(AssertionError):
    pass


def _check(ok: bool, message: str, failures: list[str]) -> None:
    status = "ok  " if ok else "FAIL"
    print(f"[soak] {status} {message}")
    if not ok:
        failures.append(message)


def fleet_drill(
    seed: int, steps: int, n_hosts: int = 4, n_micro: int = 8,
    device: str = "cuda",
) -> list[str]:
    """Run a fleet under seeded slow/hang/restore faults; return failures."""
    from ..adapt import ControlLoop
    from ..adapt.fleet import SimulatedFleet
    from ..core.timers import TimerDB
    from .inject import apply_fleet_event
    from .plan import FLEET_FAULTS, FaultPlan

    failures: list[str] = []
    db = TimerDB()
    fleet = SimulatedFleet(
        n_hosts, n_micro, window=4, threshold=1.5, evict_after=6, db=db,
        device=device,
    )
    loop = ControlLoop(db=db)
    loop.register(fleet.controller)
    # faults only land in the first 3/4 of the run: the drill asserts
    # *recovery*, so the loop gets a deterministic grace window to converge
    plan = FaultPlan.random(
        seed, steps * 3 // 4, kinds=FLEET_FAULTS, rate=0.03, hosts=range(n_hosts)
    )
    print(f"[soak] fleet drill: {len(plan.events)} fault events over {steps} steps")
    # boundedness is measured over the steady-state tail: faults stop at 3/4,
    # detection windows and eviction streaks settle by 7/8, so from there to
    # the end a leak-free control loop creates zero new timer/counter rows
    # (a first-time eviction right after the midpoint is legitimate growth)
    mark = steps * 7 // 8
    mark_names: set[str] | None = None
    mark_counters: int | None = None
    for step in range(steps):
        for event in plan.at(step):
            if event.target in fleet.costs:
                print(f"[soak]   {event.describe()}")
                apply_fleet_event(event, fleet)
        fleet.run_step(step)
        loop.poll(step)
        if step == mark:
            mark_names = set(db.names())
            mark_counters = len(db.snapshot())
    # -- recovery: the end state is one the detector itself calls healthy ----
    # mirror the flagging rule (mean > threshold * median of host means): a
    # converged controller leaves no survivor above its own detection line
    seconds = {
        h: s for h, s in fleet.last_step_seconds.items() if h in fleet.plan.weights
    }
    median = max(statistics.median(seconds.values()), 1e-9)
    worst_ratio = max(seconds.values()) / median
    _check(
        worst_ratio <= fleet.detector.threshold * 1.05,
        f"fleet rebalanced: worst end host at {worst_ratio:.2f}x the median "
        f"(detector threshold {fleet.detector.threshold})",
        failures,
    )
    _check(
        len(fleet.plan.hosts) >= 1,
        f"fleet survived: {len(fleet.plan.hosts)} active hosts "
        f"({len(fleet.evicted)} evicted)",
        failures,
    )
    # -- boundedness: the steady-state tail created no new timers/counters ---
    grown = set(db.names()) - (mark_names or set())
    _check(
        not grown,
        f"timer set bounded: {len(grown)} new timers in tail {sorted(grown)[:5]}",
        failures,
    )
    _check(
        len(db.snapshot()) == mark_counters,
        f"snapshot bounded: {mark_counters} -> {len(db.snapshot())} rows",
        failures,
    )
    rebalances = sum(
        1 for a in loop.actions if a.action in ("rebalance", "restage", "restore")
    )
    print(
        f"[soak] fleet drill: {rebalances} plan adjustments, "
        f"{len(fleet.evicted)} evictions, {loop.polls} polls"
    )
    return failures


def checkpoint_drill(seed: int, steps: int = 12, device: str = "cuda") -> list[str]:
    """Train, corrupt, kill, resume; return failures."""
    from ..launch.train import TrainSettings, run_training
    from .inject import bit_flip_leaf, simulate_writer_kill
    from .plan import seeded_rng

    failures: list[str] = []
    root = tempfile.mkdtemp(prefix="repro_soak_ckpt_")
    try:
        settings = TrainSettings(
            smoke=True, steps=steps, global_batch=2, seq_len=16,
            ckpt_dir=root, ckpt_mode="fixed", ckpt_every=max(steps // 3, 1),
            ckpt_synchronous=True, report_every=0, lr_total_steps=steps,
            pipeline_stages=1, pipeline_layers=4, pipeline_micro=2,
            pipeline_width=8, device=device,
        )
        first = run_training(settings)
        _check(first["iterations"] == steps, "first run completed", failures)
        ckpts = sorted(
            d for d in os.listdir(root)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        _check(len(ckpts) >= 2, f"first run left >= 2 checkpoints ({ckpts})", failures)
        if len(ckpts) < 2:
            return failures
        # damage the newest, plant killed-writer debris; both seeded
        rng = seeded_rng(seed, "soak", "ckpt")
        bit_flip_leaf(os.path.join(root, ckpts[-1]), rng=rng)
        simulate_writer_kill(root, steps + 1, rng=rng)
        resumed = run_training(
            TrainSettings(**{**settings.__dict__, "steps": steps + 4})
        )
        resume = resumed["resume"]
        expected = int(ckpts[-2].split("_")[1])
        _check(
            resume and resume["selected_step"] == expected,
            f"resume fell back to newest valid step {expected} "
            f"(selected {resume and resume['selected_step']})",
            failures,
        )
        reasons = {q["reason"] for q in (resume or {}).get("quarantined", ())}
        _check(
            "leaf_hash_mismatch" in reasons and "stale_tmp" in reasons,
            f"both injected faults quarantined with reasons ({sorted(reasons)})",
            failures,
        )
        _check(
            resumed["iterations"] == steps + 4, "resumed run completed", failures
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200, help="fleet drill steps")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=12,
                    help="checkpoint drill training steps")
    ap.add_argument("--skip-fleet", action="store_true")
    ap.add_argument("--skip-checkpoint", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    failures: list[str] = []
    if not args.skip_fleet:
        failures += fleet_drill(args.seed, args.steps, n_hosts=args.hosts,
                                device=args.device)
    if not args.skip_checkpoint:
        failures += checkpoint_drill(args.seed, steps=args.train_steps,
                                     device=args.device)
    if failures:
        print(f"[soak] {len(failures)} FAILURE(S):", file=sys.stderr)
        for f in failures:
            print(f"[soak]   - {f}", file=sys.stderr)
        return 1
    print("[soak] all drills passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
