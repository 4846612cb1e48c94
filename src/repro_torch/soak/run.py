"""Long-run observability soak: drive train or serve for a wall-clock budget,
scrape ``/metrics`` every interval, and assert the boundedness invariants.

Where :mod:`repro_torch.faults.soak` proves the system *recovers* from injected
faults over a fixed step count, this harness proves the whole
measure → decide → act → **export** stack stays healthy over wall-clock time:

* **train mode** — a :class:`~repro_torch.adapt.fleet.SimulatedFleet` under a
  :class:`~repro_torch.adapt.ControlLoop` with seeded
  :class:`~repro_torch.faults.plan.FaultPlan` slow/hang/restore injections for the
  first ~60% of the budget, then a fault-free steady tail;
* **serve mode** — a :class:`~repro_torch.serving.ServeSession` (``--arch``,
  its smoke config unless ``--full``) under seeded open-loop traffic bursts,
  its ``ADAPT/serving`` controller steering batch width and shedding;
  ``--attn-impl pallas --norm-impl fused`` serve through the hand-written
  flash-attention and RMSNorm kernels.

Both modes run on ``--device`` (default ``cuda``; there is no fallback to the
CPU).

Every ``--interval-s`` the run scrapes the live monitor ``/metrics`` endpoint
(or renders in-process with ``--no-http``), parses it with the strict
exposition parser, and records the control loop's decision log as the delta
baseline.  After the budget, :func:`repro_torch.soak.invariants.check_snapshots`
asserts: clean parses, strictly increasing scrape clock, no ``*_total``
decrease, every ADAPT action externally visible, and flat timer/bucket/channel
cardinality over the steady tail.  Exit code is non-zero on any failure:

    PYTHONPATH=src python -m repro_torch.soak --mode both --budget-s 60 \\
        --interval-s 5 --seed 1 --out-dir soak_snapshots
    PYTHONPATH=src python -m repro_torch.soak --mode serve --full \\
        --attn-impl pallas --norm-impl fused --dtype bfloat16 --budget-s 20
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import urllib.request

from .invariants import SnapshotRecord, check_snapshots

__all__ = ["SoakConfig", "SoakResult", "main", "run_soak"]

#: steps per fault-plan round (train mode): each round draws a fresh seeded
#: plan, so fault pressure tracks however many steps the wall clock admits
_FAULT_ROUND = 256


@dataclasses.dataclass
class SoakConfig:
    mode: str = "train"            # "train" | "serve"
    budget_s: float = 60.0         # wall-clock budget for the drive loop
    interval_s: float = 5.0        # snapshot cadence (auto-shrunk if needed)
    seed: int = 0
    n_hosts: int = 4
    n_micro: int = 8
    fault_rate: float = 0.03       # per-step fault probability (train)
    fault_fraction: float = 0.6    # faults land only in this budget prefix
    scrape_http: bool = True       # scrape the live monitor; else render
    out_dir: str | None = None     # write each snapshot as a .prom file
    min_snapshots: int = 4
    tail_fraction: float = 0.25
    # serve mode's model, as :func:`repro_torch.launch.serve.run_serving`
    # takes it (an impl or dtype of None keeps the config's field)
    arch: str = "llama3.2-1b"
    smoke: bool = True             # the smoke config; False: published width
    attn_impl: str | None = None
    norm_impl: str | None = None
    dtype: str | None = None
    device: str = "cuda"           # both modes; no fallback to the CPU


@dataclasses.dataclass
class SoakResult:
    mode: str
    steps: int
    snapshots: list[SnapshotRecord]
    failures: list[str]
    summary: dict

    @property
    def ok(self) -> bool:
        return not self.failures


class _Scraper:
    """Snapshot taker: scrape (or render), strictly parse, optionally persist."""

    def __init__(self, cfg: SoakConfig, exporter, loop, server) -> None:
        from ..monitor import TEXT_CONTENT_TYPE

        self._cfg = cfg
        self._exporter = exporter
        self._loop = loop
        self._server = server
        self._ctype = TEXT_CONTENT_TYPE
        self.records: list[SnapshotRecord] = []
        if cfg.out_dir:
            os.makedirs(cfg.out_dir, exist_ok=True)

    def snap(self, step: int) -> SnapshotRecord:
        from ..monitor import ExpositionError, parse_exposition

        cfg = self._cfg
        # the delta baseline MUST be taken before the scrape: the invariant is
        # "every action already in the log is visible on the wire"
        actions = dict(self._loop.summary()["action_counts"])
        record = SnapshotRecord(
            index=len(self.records), step=step, actions=actions,
            source="http" if self._server is not None else "render",
        )
        try:
            if self._server is not None:
                url = f"http://127.0.0.1:{self._server.port}/metrics"
                with urllib.request.urlopen(url, timeout=30) as resp:
                    ctype = resp.headers.get("Content-Type", "")
                    text = resp.read().decode("utf-8")
                if ctype != self._ctype:
                    record.parse_error = f"wrong content type {ctype!r}"
            else:
                text = self._exporter.render()
        except OSError as exc:
            record.parse_error = f"scrape failed: {exc}"
            text = ""
        if record.parse_error is None:
            try:
                record.exposition = parse_exposition(text)
            except ExpositionError as exc:
                record.parse_error = str(exc)
        if cfg.out_dir and text:
            record.path = os.path.join(
                cfg.out_dir, f"{cfg.mode}_{record.index:03d}.prom"
            )
            with open(record.path, "w", encoding="utf-8") as f:
                f.write(text)
        self.records.append(record)
        return record


def _effective_interval(cfg: SoakConfig) -> float:
    """Shrink the cadence so even a tiny budget yields enough snapshots for
    the tail math (min_snapshots, >= 2 of them in the tail)."""
    return max(min(cfg.interval_s, cfg.budget_s / (cfg.min_snapshots + 1)), 0.01)


def _soak_train(cfg: SoakConfig) -> SoakResult:
    from ..adapt import ControlLoop
    from ..adapt.fleet import SimulatedFleet
    from ..core.timers import TimerDB
    from ..faults.inject import apply_fleet_event
    from ..faults.plan import FLEET_FAULTS, FaultPlan
    from ..monitor import MetricsExporter, MonitorServer

    db = TimerDB()
    fleet = SimulatedFleet(
        cfg.n_hosts, cfg.n_micro, window=4, threshold=1.5, evict_after=6, db=db,
        device=cfg.device,
    )
    loop = ControlLoop(db=db)
    loop.register(fleet.controller)
    exporter = MetricsExporter(db, control_loop=loop, detector=fleet.detector)
    server = None
    if cfg.scrape_http:
        server = MonitorServer(0, db, exporter=exporter)
        server.start()
    scraper = _Scraper(cfg, exporter, loop, server)

    interval = _effective_interval(cfg)
    t0 = time.monotonic()
    deadline = t0 + cfg.budget_s
    fault_deadline = t0 + cfg.budget_s * cfg.fault_fraction
    next_snap = t0 + interval
    step = 0
    n_faults = 0
    plan = None
    try:
        while time.monotonic() < deadline:
            round_idx, offset = divmod(step, _FAULT_ROUND)
            if offset == 0:
                plan = (
                    FaultPlan.random(
                        cfg.seed + 7919 * round_idx, _FAULT_ROUND,
                        kinds=FLEET_FAULTS, rate=cfg.fault_rate,
                        hosts=range(cfg.n_hosts),
                    )
                    if time.monotonic() < fault_deadline
                    else None
                )
            if plan is not None:
                for event in plan.at(offset):
                    if event.target in fleet.costs:
                        n_faults += 1
                        apply_fleet_event(event, fleet)
            fleet.run_step(step)
            loop.poll(step)
            step += 1
            if time.monotonic() >= next_snap:
                scraper.snap(step)
                next_snap += interval
        while len(scraper.records) < cfg.min_snapshots:
            time.sleep(0.01)
            scraper.snap(step)
    finally:
        if server is not None:
            server.stop()
    failures = check_snapshots(
        scraper.records, tail_fraction=cfg.tail_fraction
    )
    return SoakResult(
        mode="train", steps=step, snapshots=scraper.records, failures=failures,
        summary={
            "faults_injected": n_faults,
            "evicted_hosts": sorted(fleet.evicted),
            "adapt": loop.summary(),
        },
    )


def _soak_serve(cfg: SoakConfig) -> SoakResult:
    import numpy as np
    import torch

    from ..configs import get_config, get_smoke_config
    from ..core.timers import TimerDB
    from ..models import model as M
    from ..monitor import MetricsExporter, MonitorServer, serving_payload
    from ..serving import Request, ServeSession, ServiceLevel

    db = TimerDB()
    arch = get_smoke_config(cfg.arch) if cfg.smoke else get_config(cfg.arch)
    overrides = {"attn_impl": cfg.attn_impl, "norm_impl": cfg.norm_impl, "dtype": cfg.dtype}
    arch = arch.replace(**{k: v for k, v in overrides.items() if v is not None})
    device = torch.device(cfg.device)
    params = M.init_params(arch, torch.Generator(device=device).manual_seed(cfg.seed), device)
    prompt_len, max_new = 16, 6
    engine = ServeSession(
        arch, params,
        n_slots=4,
        max_seq=M.prefix_positions(arch) + prompt_len + max_new + 8,
        block_size=8,
        slo=ServiceLevel(target_decode_ms=5.0, max_queue_delay_s=0.5),
        db=db,
        device=device,
    )
    loop = engine.control_loop
    exporter = MetricsExporter(
        db, control_loop=loop, serving_fn=serving_payload(engine)
    )
    server = None
    if cfg.scrape_http:
        server = MonitorServer(0, db, exporter=exporter,
                               serving_fn=serving_payload(engine))
        server.start()
    scraper = _Scraper(cfg, exporter, loop, server)

    rng = np.random.default_rng(cfg.seed)
    interval = _effective_interval(cfg)
    t0 = time.monotonic()
    deadline = t0 + cfg.budget_s
    next_snap = t0 + interval
    rid = 0
    try:
        while time.monotonic() < deadline:
            # seeded bursty open-loop traffic: keep a few requests queued so
            # the serving controller has pressure to act on
            burst = int(rng.integers(1, 4))
            while engine.queue_depth < burst:
                engine.submit(Request(
                    rid,
                    prompt=rng.integers(0, arch.vocab_size,
                                        int(rng.integers(4, prompt_len))).tolist(),
                    max_new_tokens=max_new,
                ))
                rid += 1
            engine.step()
            if time.monotonic() >= next_snap:
                scraper.snap(engine.stats()["steps"])
                next_snap += interval
        while len(scraper.records) < cfg.min_snapshots:
            time.sleep(0.01)
            scraper.snap(engine.stats()["steps"])
    finally:
        if server is not None:
            server.stop()
    failures = check_snapshots(
        scraper.records, tail_fraction=cfg.tail_fraction
    )
    stats = engine.stats()
    return SoakResult(
        mode="serve", steps=int(stats["steps"]), snapshots=scraper.records,
        failures=failures,
        summary={
            "submitted": rid,
            "completed": stats["completed"],
            "shed": stats["shed"],
            "adapt": loop.summary(),
            # model calls, as the engine's phase timers count them
            "prefills": db.get("serve/prefill").count,
            "decode_steps": db.get("serve/decode").count,
        },
    )


def run_soak(cfg: SoakConfig) -> SoakResult:
    """Run one soak mode end to end; the result carries every snapshot record
    and the invariant failures (empty == pass)."""
    if cfg.mode == "train":
        result = _soak_train(cfg)
    elif cfg.mode == "serve":
        result = _soak_serve(cfg)
    else:
        raise ValueError(f"unknown soak mode {cfg.mode!r}")
    return result


def _report(result: SoakResult) -> None:
    ok = "ok  " if result.ok else "FAIL"
    print(
        f"[soak] {ok} {result.mode}: {result.steps} steps, "
        f"{len(result.snapshots)} snapshots, "
        f"{result.summary.get('adapt', {}).get('n_actions', 0)} adapt actions"
    )
    for failure in result.failures:
        print(f"[soak]   - {failure}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["train", "serve", "both"], default="train")
    ap.add_argument("--budget-s", type=float, default=60.0,
                    help="wall-clock budget per mode (seconds)")
    ap.add_argument("--interval-s", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--fault-rate", type=float, default=0.03)
    ap.add_argument("--out-dir", default=None,
                    help="write each snapshot as <mode>_<idx>.prom here")
    ap.add_argument("--no-http", dest="http", action="store_false",
                    help="render in-process instead of scraping the monitor")
    ap.add_argument("--arch", default="llama3.2-1b", help="serve mode's architecture")
    ap.add_argument("--full", action="store_true",
                    help="serve the published width (default: the smoke config)")
    ap.add_argument("--attn-impl", default=None, help="e.g. pallas: the flash kernel")
    ap.add_argument("--norm-impl", default=None, help="e.g. fused: the RMSNorm kernel")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    modes = ["train", "serve"] if args.mode == "both" else [args.mode]
    failures: list[str] = []
    for mode in modes:
        cfg = SoakConfig(
            mode=mode, budget_s=args.budget_s, interval_s=args.interval_s,
            seed=args.seed, n_hosts=args.hosts, n_micro=args.micro,
            fault_rate=args.fault_rate, scrape_http=args.http,
            out_dir=args.out_dir, arch=args.arch, smoke=not args.full,
            attn_impl=args.attn_impl, norm_impl=args.norm_impl, dtype=args.dtype,
            device=args.device,
        )
        result = run_soak(cfg)
        _report(result)
        failures += [f"{mode}: {f}" for f in result.failures]
    if failures:
        print(f"[soak] {len(failures)} FAILURE(S)", file=sys.stderr)
        return 1
    print("[soak] all invariants held")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
