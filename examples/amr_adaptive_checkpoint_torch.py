"""Paper §4 reproduction on the PyTorch port: adaptive checkpointing on an
AMR-style workload.

The paper's experiment: the Ccatie/Carpet AMR run starts on a 40³ grid and
adds one refinement level every N iterations, so compute per iteration grows
O(2^L) (finer levels subcycle) while checkpoint data grows O(L).  With
fixed-interval checkpointing the run spends 19% of wall time checkpointing;
bounding the fraction at 5% with AdaptCheck holds the bound and cuts total
runtime ~17%.

This example reproduces that shape with ``repro_torch``: a 3D wave-equation
(finite-difference) solver on a growing level hierarchy whose levels live on
``--device`` (the card by default), checkpointed through the real
CheckpointManager, scheduled through the real scheduler + timer database, and
steered by the real AdaptiveCheckpointController.  Run:

    PYTHONPATH=src python examples/amr_adaptive_checkpoint_torch.py            # both runs
    PYTHONPATH=src python examples/amr_adaptive_checkpoint_torch.py --mode fixed
    PYTHONPATH=src python examples/amr_adaptive_checkpoint_torch.py --device cpu

A benchmark harness imports ``run_experiment`` and asserts the paper's claims
(bound held, double-digit runtime cut).  ``--ckpt-delay`` is parsed and read
nowhere, as in ``examples/amr_adaptive_checkpoint.py``: the injected delays
are ``AMRSettings``' own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

sys.path.insert(0, "src")  # allow running from the repo root without install

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AdaptiveCheckpointController,
    AdaptiveCheckpointPolicy,
    RunState,
)
from repro_torch.timing import TimingSession  # noqa: E402


@dataclass
class AMRSettings:
    mode: str = "adaptive"             # "fixed" | "adaptive" | "interval"
    iterations: int = 120
    grid: int = 48                     # per-level grid (paper: 40³)
    substeps: int = 10                 # leapfrog steps per (level-)iteration
    max_levels: int = 4
    regrid_every: int = 30             # paper: 5120
    fixed_every: int = 8               # paper: 512 (scaled to iteration count)
    max_fraction: float = 0.05         # paper's 5% bound
    max_interval_s: float = 3.0        # "interval" mode bound (paper §4 last run)
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "amr_ckpt")
    ckpt_delay_s: float = 0.01         # emulated filesystem latency per write
    ckpt_delay_s_per_mb: float = 0.02  # + size-proportional cost (O(L) data)
    seed: int = 0
    device: str = "cuda"


def _make_level(grid: int, seed: int, device: str | torch.device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    u = 0.1 * torch.randn((grid, grid, grid), generator=gen, device=device,
                          dtype=torch.float32)
    return {"u": u, "v": torch.zeros_like(u)}


def _wave_step(level: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Leapfrog step of the 3D wave equation with a 7-point Laplacian."""
    u, v = level["u"], level["v"]
    lap = (
        torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
        + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
        + torch.roll(u, 1, 2) + torch.roll(u, -1, 2)
        - 6.0 * u
    )
    v = v + 0.1 * lap
    u = u + 0.1 * v
    return {"u": u, "v": v}


def _wait(device: torch.device) -> None:
    """Block until the device has run everything queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(settings: AMRSettings) -> dict[str, object]:
    # a fresh session per experiment run: no global-DB juggling, and the two
    # modes of the paper's A/B never share timers
    sess = TimingSession()
    sch = sess.scheduler
    st = RunState(max_iterations=settings.iterations)
    device = torch.device(settings.device)

    manager = CheckpointManager(
        settings.ckpt_dir + f"_{settings.mode}", synchronous=True,
        fsync=False, delay_s=settings.ckpt_delay_s,
        delay_s_per_mb=settings.ckpt_delay_s_per_mb, keep_n=2,
    )
    if settings.mode == "interval":
        # paper §4 second experiment: bound only the wall-time interval between
        # checkpoints — the fraction bound is set ≈0 so nothing else admits
        policy = AdaptiveCheckpointPolicy(
            mode="adaptive", max_fraction=1e-9,
            max_interval_seconds=settings.max_interval_s, use_predictor=True,
        )
    else:
        policy = AdaptiveCheckpointPolicy(
            mode="fixed" if settings.mode == "fixed" else "adaptive",
            every_iterations=settings.fixed_every,
            max_fraction=settings.max_fraction if settings.mode == "adaptive" else 1.0,
            max_interval_seconds=1e9,
            use_predictor=settings.mode != "fixed",
        )
    controller = AdaptiveCheckpointController(policy)
    fraction_trace: list[dict[str, float]] = []

    def startup(s: RunState) -> None:
        s["levels"] = [_make_level(settings.grid, settings.seed, device)]
        # a first step outside the loop, so one-time device set-up (context,
        # allocator, kernel loading) is not attributed to the loop
        _wave_step(s["levels"][0])
        _wait(device)
        controller.start_run(time.monotonic())

    sch.schedule(startup, bin="STARTUP", thorn="amr")

    def maybe_regrid(s: RunState) -> None:
        """Add a refinement level every `regrid_every` iterations (paper: the
        collapse drives new levels; data grows O(L), compute grows O(2^L))."""
        want = min(1 + s.iteration // settings.regrid_every, settings.max_levels)
        while len(s["levels"]) < want:
            level = _make_level(settings.grid, settings.seed + len(s["levels"]), device)
            s["levels"] = s["levels"] + [level]

    sch.schedule(maybe_regrid, bin="PRESTEP", thorn="carpet")

    def evolve(s: RunState) -> None:
        new_levels = []
        for l, level in enumerate(s["levels"]):
            # subcycling: finer levels take 2^l sub-iterations
            for _ in range(settings.substeps * 2 ** l):
                level = _wave_step(level)
            # each level done on the device: the EVOL timer, which the
            # controller divides by, holds the device's time
            _wait(device)
            new_levels.append(level)
        s["levels"] = new_levels

    sch.schedule(evolve, bin="EVOL", thorn="ccatie")

    ckpt_timer = "CHECKPOINT/adaptcheck::write"
    ckpt_scope = sess.scope_handle(ckpt_timer)

    def checkpoint(s: RunState) -> None:
        now = time.monotonic()
        total = now - controller.started_at
        spent = ckpt_scope.seconds()
        nbytes_next = sum(
            x.numel() * x.element_size() for lv in s["levels"] for x in lv.values()
        )
        decision = controller.decide(
            iteration=s.iteration, now=now, total_seconds=total,
            checkpoint_seconds=spent, next_checkpoint_bytes=nbytes_next,
        )
        fraction_trace.append(
            {"iteration": s.iteration, "fraction": decision.fraction,
             "levels": len(s["levels"]), "checkpointed": float(decision.checkpoint)}
        )
        if not decision.checkpoint:
            return
        with ckpt_scope:
            stats = manager.save(s.iteration, {"levels": s["levels"]})
        controller.observe_checkpoint(time.monotonic(), stats["blocking_seconds"],
                                      stats["nbytes"])

    sch.schedule(checkpoint, bin="CHECKPOINT", thorn="adaptcheck")

    def shutdown(s: RunState) -> None:
        manager.close()

    sch.schedule(shutdown, bin="SHUTDOWN", thorn="amr")

    with sess:
        sch.run(st)

    # loop wall time (excludes STARTUP, matching the controller's accounting)
    total = time.monotonic() - controller.started_at
    ckpt = ckpt_scope.seconds()
    return {
        "mode": settings.mode,
        "iterations": st.iteration,
        "total_seconds": total,
        "checkpoint_seconds": ckpt,
        "checkpoint_fraction": ckpt / total if total else 0.0,
        "n_checkpoints": controller.n_checkpoints,
        "n_suppressed": controller.n_suppressed,
        "final_levels": len(st["levels"]),
        "fraction_trace": fraction_trace,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["fixed", "adaptive", "interval", "both"],
                    default="both")
    ap.add_argument("--iterations", type=int, default=120)
    ap.add_argument("--ckpt-delay", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    modes = ["fixed", "adaptive"] if args.mode == "both" else [args.mode]
    results = {}
    for mode in modes:
        res = run_experiment(AMRSettings(mode=mode, iterations=args.iterations,
                                         device=args.device))
        res_small = {k: v for k, v in res.items() if k != "fraction_trace"}
        print(f"[amr:{mode}] {json.dumps(res_small, indent=1)}")
        results[mode] = res
    if len(results) == 2:
        f, a = results["fixed"], results["adaptive"]
        cut = 1.0 - a["total_seconds"] / f["total_seconds"]
        print(f"\n[amr] fixed:    {f['checkpoint_fraction']:.1%} of wall time checkpointing")
        print(f"[amr] adaptive: {a['checkpoint_fraction']:.1%} of wall time checkpointing "
              f"(bound 5%)")
        print(f"[amr] total runtime cut: {cut:.1%} (paper: ~17%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
