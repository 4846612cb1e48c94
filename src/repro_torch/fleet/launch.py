"""Multi-process fleet launcher: real subprocess ranks under the control plane.

``python -m repro_torch.fleet.launch --hosts 2 --steps 40`` spawns ``--hosts`` real
worker processes (:mod:`repro_torch.fleet.worker`) over a file-backed rendezvous
store and runs the controller loop in this process: the straggler detector
gathers every rank's step times through the epoch-fenced
:class:`~repro_torch.fleet.transport.FleetTransport`, the
:class:`~repro_torch.adapt.stragglers.StragglerResponse` rebalances/evicts through
the checkpoint-before-evict barrier and the payback gate, and the
:class:`~repro_torch.fleet.membership.FleetController` admits mid-run joins and
evicts heartbeat-expired ranks.

The event script (``--join-at STEP:HOST``, ``--kill-at``, ``--hang-at``,
``--cont-at``, ``--slow-at STEP:HOST:FACTOR``) drives real process-level
faults — SIGKILL, SIGSTOP/SIGCONT, pacing throttles — at controller poll
steps, which is what the tier-1 smoke and the nightly drill exercise.

The re-shard cost model is **measured, not assumed**: it seeds from the
committed checkpoint benchmark baselines and then folds in the startup durable
save + restore this very launcher performs, so the payback gate amortizes
against this machine's actual checkpoint latency.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..adapt.checkpoint import CheckpointControl
from ..adapt.controller import ControlLoop
from ..adapt.stragglers import StragglerResponse
from ..checkpoint import CheckpointManager
from ..core.adaptive import AdaptiveCheckpointPolicy
from ..core.timers import TimerDB
from ..dist.pipeline import MicrobatchPlan
from ..dist.stragglers import StragglerDetector
from ..monitor.export import MetricsExporter
from ..monitor.server import MonitorServer
from .membership import FleetController, Membership
from .payback import PaybackPolicy, ReshardCost
from .store import FileStore
from .transport import FleetTransport

__all__ = ["FleetSettings", "run_fleet"]


@dataclass
class FleetSettings:
    """Everything one fleet run needs; the CLI populates one of these."""

    hosts: int = 2
    steps: int = 40
    n_micro: int = 8
    step_floor_s: float = 0.02
    poll_interval_s: float = 0.1
    liveness_timeout_s: float = 1.0
    horizon_steps: int = 50
    extra_reshard_cost_s: float = 0.0
    seed: int = 0
    pipeline_stages: int = 0
    rendezvous: str | None = None
    monitor_port: int | None = None
    metrics_textfile: str | None = None
    snapshot_every: int = 5
    #: scripted events, each a (poll step, host) pair
    join_at: list[tuple[int, int]] = field(default_factory=list)
    kill_at: list[tuple[int, int]] = field(default_factory=list)
    hang_at: list[tuple[int, int]] = field(default_factory=list)
    cont_at: list[tuple[int, int]] = field(default_factory=list)
    #: (poll step, host, pacing factor)
    slow_at: list[tuple[int, int, float]] = field(default_factory=list)


def _worker_env() -> dict[str, str]:
    """Subprocess env with the repo's ``src`` on PYTHONPATH (the launcher may
    itself run from a checkout rather than an installed package)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    existing = env.get("PYTHONPATH", "")
    if src not in existing.split(os.pathsep):
        env["PYTHONPATH"] = f"{src}{os.pathsep}{existing}" if existing else src
    return env


def _spawn_worker(
    root: str, host: int, settings: FleetSettings, *, join: bool = False
) -> subprocess.Popen:
    cmd = [
        sys.executable,
        "-m",
        "repro_torch.fleet.worker",
        "--root",
        root,
        "--host",
        str(host),
        "--step-floor-s",
        str(settings.step_floor_s),
        "--seed",
        str(settings.seed),
    ]
    if join:
        cmd.append("--join")
    return subprocess.Popen(
        cmd,
        env=_worker_env(),
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )


def run_fleet(settings: FleetSettings) -> dict[str, Any]:
    """Run one fleet: spawn ranks, drive the control loop, return the journal."""
    if settings.hosts < 1:
        raise ValueError(f"need at least one host, got {settings.hosts}")
    own_dir = settings.rendezvous is None
    root = settings.rendezvous or tempfile.mkdtemp(prefix="repro-fleet-")
    store = FileStore(root)

    db = TimerDB()
    plan = MicrobatchPlan.equal(range(settings.hosts), settings.n_micro)
    membership = Membership(
        store,
        plan,
        n_stages=settings.pipeline_stages,
        liveness_timeout=settings.liveness_timeout_s,
    )
    transport = FleetTransport(store, members_fn=membership.members_fn)
    detector = StragglerDetector(
        n_hosts=settings.hosts,
        window=4,
        threshold=2.0,
        db=db,
        transport=transport,
    )

    # -- measured re-shard cost: baseline seed + live save/restore ----------
    cost = ReshardCost.from_baseline()
    cost.rebuild_s += settings.extra_reshard_cost_s
    manager = CheckpointManager(
        os.path.join(root, "ckpt"), keep_n=3, synchronous=True, fsync=False
    )
    ckpt = CheckpointControl(AdaptiveCheckpointPolicy(mode="adaptive"))

    def durable_save(step: int) -> float:
        t0 = time.monotonic()
        hosts = membership.hosts
        manager.save(
            step,
            {
                "hosts": np.asarray(hosts, dtype=np.int64),
                "weights": np.asarray([plan.weights[h] for h in hosts]),
                "epoch": np.asarray([membership.epoch], dtype=np.int64),
            },
            metadata={"epoch": membership.epoch},
        )
        manager.wait()
        seconds = time.monotonic() - t0
        cost.observe(save_s=seconds)
        return seconds

    ckpt.bind_durable_save(durable_save)
    ckpt.start_run()
    # one startup save + restore, timed: the payback gate amortizes against
    # this machine's real checkpoint latency, not just the committed baseline
    durable_save(0)
    t0 = time.monotonic()
    manager.restore_latest()
    cost.observe(restore_s=time.monotonic() - t0)

    payback = PaybackPolicy(
        cost, horizon_steps=settings.horizon_steps, min_hosts=settings.hosts
    )
    response = StragglerResponse(
        detector,
        plan,
        check_every=1,
        confirm_after=2,
        evict_after=3,
        min_weight=0.25,
        on_evict=lambda host, report: membership.remove(host),
        evict_barrier=ckpt.evict_barrier,
        reshard_gate=payback.evict_gate,
    )
    fleet = FleetController(
        membership,
        transport,
        response,
        payback=payback,
        evict_barrier=ckpt.evict_barrier,
    )
    loop = ControlLoop(db=db)
    loop.register(response)
    loop.register(fleet)

    exporter = MetricsExporter(
        db,
        control_loop=loop,
        detector=detector,
        checkpoint_fn=manager.status_payload,
        fleet_fn=fleet.status_payload,
    )
    server = None
    if settings.monitor_port is not None:
        server = MonitorServer(
            settings.monitor_port,
            db,
            status_fn=lambda: {"epoch": membership.epoch, "hosts": membership.hosts},
            checkpoint_fn=manager.status_payload,
            fleet_fn=fleet.status_payload,
            exporter=exporter,
        )
        server.start()

    # -- spawn the initial ranks and index the event script -----------------
    procs: dict[int, subprocess.Popen] = {
        h: _spawn_worker(root, h, settings) for h in range(settings.hosts)
    }
    def _by_step(events):
        out: dict[int, list] = {}
        for step, *rest in events:
            out.setdefault(step, []).append(rest)
        return out

    joins = _by_step(settings.join_at)
    kills = _by_step(settings.kill_at)
    hangs = _by_step(settings.hang_at)
    conts = _by_step(settings.cont_at)
    slows = _by_step(settings.slow_at)

    def _signal(host: int, sig: int) -> None:
        proc = procs.get(host)
        if proc is None:
            return
        try:  # the target may already be dead (a drill can kill then hang)
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass

    snapshots: list[dict[str, Any]] = []

    def snap(step: int) -> None:
        # in-process truth first, then the scrape: check_snapshots compares
        # the wire view against the decision log taken just before it
        actions = dict(loop.summary()["action_counts"])
        snapshots.append(
            {"step": step, "actions": actions, "exposition": exporter.render()}
        )

    snap(-1)
    try:
        for step in range(settings.steps):
            time.sleep(settings.poll_interval_s)
            for (host,) in joins.get(step, ()):
                procs[host] = _spawn_worker(root, host, settings, join=True)
            for (host,) in kills.get(step, ()):
                _signal(host, signal.SIGKILL)
            for (host,) in hangs.get(step, ()):
                _signal(host, signal.SIGSTOP)
            for (host,) in conts.get(step, ()):
                _signal(host, signal.SIGCONT)
            for host, factor in slows.get(step, ()):
                store.put(f"faults/{host}", {"slow": factor})
            loop.poll(step)
            if settings.snapshot_every and (step + 1) % settings.snapshot_every == 0:
                snap(step)
    finally:
        store.put("shutdown", {"t": time.time(), "step": settings.steps})
        for host in procs:
            # a SIGSTOP'd rank cannot see the shutdown key; resume it first
            _signal(host, signal.SIGCONT)
        for host, proc in procs.items():
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        if server is not None:
            server.stop()

    snap(settings.steps)
    if settings.metrics_textfile:
        exporter.write_textfile(settings.metrics_textfile)

    finals = {
        key.rsplit("/", 1)[1]: value for key, value in store.scan("final").items()
    }
    summary = {
        "root": root,
        "own_rendezvous": own_dir,
        "steps": settings.steps,
        "epoch": membership.epoch,
        "hosts": membership.hosts,
        "shares": plan.shares() if plan.weights else {},
        "joins_total": fleet.joins_total,
        "leaves_total": fleet.leaves_total,
        "deferred_leaves": fleet.deferred_leaves,
        "reshard_defers": dict(payback.defers),
        "deferred_reshards": response.deferred_reshards,
        "stale_rejected": transport.stale_rejected,
        "barrier_saves": ckpt.barrier_saves,
        "reshard_cost_s": round(cost.total(), 6),
        "action_counts": loop.summary()["action_counts"],
        "actions": [a.describe() for a in loop.actions],
        "finals": finals,
        "snapshots": snapshots,
    }
    return summary


def _parse_events(values: list[str], with_arg: bool = False) -> list[tuple]:
    out: list[tuple] = []
    for value in values or []:
        parts = value.split(":")
        want = 3 if with_arg else 2
        if len(parts) != want:
            shape = "STEP:HOST:FACTOR" if with_arg else "STEP:HOST"
            raise SystemExit(f"bad event {value!r}; expected {shape}")
        if with_arg:
            out.append((int(parts[0]), int(parts[1]), float(parts[2])))
        else:
            out.append((int(parts[0]), int(parts[1])))
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Run a real multi-process fleet over the rendezvous store"
    )
    parser.add_argument("--hosts", type=int, default=2)
    parser.add_argument("--steps", type=int, default=40, help="controller polls")
    parser.add_argument("--n-micro", type=int, default=8)
    parser.add_argument("--step-floor-s", type=float, default=0.02)
    parser.add_argument("--poll-interval-s", type=float, default=0.1)
    parser.add_argument("--liveness-timeout-s", type=float, default=1.0)
    parser.add_argument("--horizon-steps", type=int, default=50)
    parser.add_argument(
        "--reshard-cost-s",
        type=float,
        default=0.0,
        help="extra rebuild seconds added on top of the measured save+restore",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pipeline-stages", type=int, default=0)
    parser.add_argument("--rendezvous", default=None)
    parser.add_argument("--monitor-port", type=int, default=None)
    parser.add_argument("--metrics-textfile", default=None)
    parser.add_argument("--join-at", action="append", metavar="STEP:HOST")
    parser.add_argument("--kill-at", action="append", metavar="STEP:HOST")
    parser.add_argument("--hang-at", action="append", metavar="STEP:HOST")
    parser.add_argument("--cont-at", action="append", metavar="STEP:HOST")
    parser.add_argument("--slow-at", action="append", metavar="STEP:HOST:FACTOR")
    parser.add_argument("--json", action="store_true", help="print the full journal")
    args = parser.parse_args(argv)

    settings = FleetSettings(
        hosts=args.hosts,
        steps=args.steps,
        n_micro=args.n_micro,
        step_floor_s=args.step_floor_s,
        poll_interval_s=args.poll_interval_s,
        liveness_timeout_s=args.liveness_timeout_s,
        horizon_steps=args.horizon_steps,
        extra_reshard_cost_s=args.reshard_cost_s,
        seed=args.seed,
        pipeline_stages=args.pipeline_stages,
        rendezvous=args.rendezvous,
        monitor_port=args.monitor_port,
        metrics_textfile=args.metrics_textfile,
        join_at=_parse_events(args.join_at),
        kill_at=_parse_events(args.kill_at),
        hang_at=_parse_events(args.hang_at),
        cont_at=_parse_events(args.cont_at),
        slow_at=_parse_events(args.slow_at, with_arg=True),
    )
    summary = run_fleet(settings)
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(
            f"fleet done: epoch={summary['epoch']} hosts={summary['hosts']} "
            f"joins={summary['joins_total']} leaves={summary['leaves_total']} "
            f"defers={summary['reshard_defers']} "
            f"stale_rejected={summary['stale_rejected']}"
        )
        for line in summary["actions"]:
            print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
