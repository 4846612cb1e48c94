"""Training launcher of the PyTorch port: the scheduler-driven loop with the
full timing infrastructure and the unified runtime-adaptation control plane.

Every lifecycle phase is a scheduled routine in a Cactus-style bin, so the
timer database holds a complete profile with zero manual instrumentation.
All runtime adaptation goes through ONE :class:`repro_torch.adapt.ControlLoop`
polled from the ANALYSIS bin: straggler response
(:class:`repro_torch.adapt.StragglerResponse` over the cross-host step-time
reduction).  Every decision lands in the ``ADAPT/`` section of the timer
report.

``--full`` trains the published width of the architecture (default: its
smoke config); ``--attn-impl pallas --norm-impl fused`` select the
hand-written flash-attention and RMSNorm kernels, whose backward kernels the
loss then differentiates through.  The step runs on ``--device`` (default
``cuda``); ``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.launch.train --full --arch llama3.2-1b \\
        --attn-impl pallas --norm-impl fused --steps 6 --batch 4 --seq 1024 --report

Checkpoint writes, restore and AdaptCheck admission (``ckpt_dir`` and the
other ``ckpt_*`` settings, ``queue_seconds``), the pipeline-parallel path
(``pipeline_stages``) and the monitor surfaces (``monitor_port``,
``metrics_textfile``, ``status_path``) raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

import numpy as np
import torch

from ..adapt import ControlLoop, StragglerResponse
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core import (
    RunState,
    TimerLogger,
    adapt_rows,
    bin_distribution,
    format_report,
    format_tree_report,
    param_registry,
    straggler_rows,
    timer_db,
    tree_rows,
)
from ..core.clocks import CounterClock, register_clock
from ..data import DataLoader, SyntheticConfig, SyntheticLM
from ..dist.pipeline import MicrobatchPlan
from ..dist.stragglers import StragglerDetector
from ..kernels import build
from ..models import model as M
from ..models.config import ArchConfig, ShapeConfig
from ..optim import AdamWConfig, init_opt_state
from ..timing import TimingSession
from .steps import make_train_step

__all__ = ["TrainSettings", "run_training", "main"]

#: settings whose code is not yet ported -> the ROADMAP Queue 1 item that ports it
_NOT_YET_PORTED = {
    "ckpt_dir": "item 2, checkpointing",
    "ckpt_mode": "item 2, checkpointing",
    "ckpt_every": "item 2, checkpointing",
    "ckpt_max_fraction": "item 2, checkpointing",
    "ckpt_max_interval_s": "item 2, checkpointing",
    "queue_seconds": "item 2, checkpointing",
    "pipeline_stages": "item 6, distribution",
    "monitor_port": "item 7, monitor and soak",
    "metrics_textfile": "item 7, monitor and soak",
    "status_path": "item 7, monitor and soak",
}


@dataclasses.dataclass
class TrainSettings:
    arch: str = "llama3.2-1b"
    smoke: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    peak_lr: float = 1e-3
    ckpt_dir: str | None = None
    ckpt_mode: str = "adaptive"          # "adaptive" | "fixed" | "off"
    ckpt_every: int = 512                # fixed mode
    ckpt_max_fraction: float = 0.05      # adaptive mode
    ckpt_max_interval_s: float = 60.0
    queue_seconds: float | None = None
    report_every: int = 25
    log_path: str | None = None
    status_path: str | None = None
    monitor_port: int | None = None
    metrics_textfile: str | None = None
    seed: int = 0
    data_mode: str = "copy"
    #: LR-schedule horizon; decoupled from `steps` so an interrupted run and
    #: its resumption share the same schedule (restart determinism)
    lr_total_steps: int | None = None
    pipeline_stages: int = 0
    #: where the step runs; the kernels need "cuda", "cpu" runs their plain versions
    device: str = "cuda"
    #: config overrides (None keeps the config's value)
    attn_impl: str | None = None
    norm_impl: str | None = None


def _flops_per_step(cfg: ArchConfig, tokens: int) -> float:
    _, active = M.param_counts(cfg)
    return 6.0 * active * tokens


def _check_ported(settings: TrainSettings) -> None:
    defaults = {f.name: f.default for f in dataclasses.fields(TrainSettings)}
    for name, item in _NOT_YET_PORTED.items():
        if getattr(settings, name) != defaults[name]:
            raise NotImplementedError(
                f"TrainSettings.{name} is not yet ported (ROADMAP Queue 1 {item})"
            )


def run_training(
    settings: TrainSettings,
    cfg: ArchConfig | None = None,
    control_loop: ControlLoop | None = None,
    session: TimingSession | None = None,
) -> dict[str, Any]:
    """Run the scheduled training loop; returns a summary dict.

    ``session`` supplies the whole timing stack (database + scheduler +
    control loop) as one :class:`repro_torch.timing.TimingSession`; by
    default the launcher bundles one over the process-global database, so a
    bare call still profiles into ``timer_db()``.  ``control_loop`` remains
    the narrower injection point and is ignored when a session is passed.
    ``cfg`` replaces the registry's config for ``settings.arch``; the
    settings' ``attn_impl``/``norm_impl`` apply on top of either.
    """
    _check_ported(settings)
    sess = (
        session
        if session is not None
        else TimingSession(timer_db(), control_loop=control_loop)
    )
    db = sess.db
    registry = param_registry()
    sch = sess.scheduler
    st = RunState(max_iterations=settings.steps)
    # checkpoint-label convention: the number of optimizer updates applied,
    # i.e. the next iteration to execute
    st["updates"] = 0

    if cfg is None:
        cfg = get_smoke_config(settings.arch) if settings.smoke else get_config(settings.arch)
    overrides = {"attn_impl": settings.attn_impl, "norm_impl": settings.norm_impl}
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    device = torch.device(settings.device)
    shape = ShapeConfig("train_local", "train", settings.seq_len, settings.global_batch)

    logger = TimerLogger(settings.log_path, db) if settings.log_path else None
    model_flops = _flops_per_step(cfg, settings.global_batch * settings.seq_len)

    # --- the control plane: one loop, every adaptation registered on it ----------
    loop = sess.control_loop
    # AdaptCheck admission (CheckpointControl) joins the loop with the
    # checkpointing slice; until then every ckpt_* setting raises.
    # Single-process topology: this host feeds its own EVOL step timer into
    # the reduction; multi-host launchers hand the detector a transport
    detector = StragglerDetector(n_hosts=1, db=db)
    loop.register(
        StragglerResponse(
            detector,
            MicrobatchPlan.equal([0], n_micro=1),
            check_every=8,
            local_feed=(0, "EVOL/trainer::train_step"),
        )
    )
    sch.attach_control_loop(loop, bin="ANALYSIS")
    # training-event clock registered mid-run (the paper's extensibility path:
    # every timer picks it up from its next window) + lock-free channel cells
    # resolved once for the hot loop
    register_clock(
        "events",
        lambda: CounterClock("events", {"tokens": "count", "steps": "count"}),
    )
    bump_flops = sess.counter("xla_flops", absolute=True)
    bump_tokens = sess.counter("tokens", absolute=True)
    bump_steps = sess.counter("steps", absolute=True)

    # --- STARTUP ----------------------------------------------------------------
    def startup(s: RunState) -> None:
        opt_cfg = AdamWConfig()
        horizon = settings.lr_total_steps or settings.steps
        built = make_train_step(
            cfg, shape, opt_cfg=opt_cfg,
            peak_lr=settings.peak_lr, total_steps=max(horizon, 2),
            warmup_steps=max(min(100, horizon // 10), 1),
        )
        s["built"] = built
        s["exec"] = built.fn
        # absolute-path scope: nests under the STARTUP driver routine in the
        # tree report; on the card it holds the kernels' nvcc build
        with sess.scope_handle("STARTUP/compile"):
            if device.type == "cuda":
                build.build_all()

        source = SyntheticLM(
            SyntheticConfig(cfg.vocab_size, settings.seq_len, settings.global_batch,
                            mode=settings.data_mode, seed=settings.seed),
            arch=cfg,
        )
        with sess.scope_handle("STARTUP/init_params"):
            generator = torch.Generator(device=device).manual_seed(settings.seed)
            s["params"] = M.init_params(cfg, generator, device)
            s["opt_state"] = init_opt_state(opt_cfg, s["params"])
        s["loader"] = DataLoader(source, start_step=0)
        registry.freeze()

    sch.schedule(startup, bin="STARTUP", thorn="driver")

    # --- PRESTEP: data ------------------------------------------------------------
    def fetch_data(s: RunState) -> None:
        batch = s["loader"].next()
        s["batch"] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in batch.items()}

    sch.schedule(fetch_data, bin="PRESTEP", thorn="data")

    # --- EVOL: the training step ------------------------------------------------------
    def train_step(s: RunState) -> None:
        params, opt_state, metrics = s["exec"](s["params"], s["opt_state"], s["batch"])
        # reading the metrics back waits for the device: the EVOL timer holds
        # the step's device time
        metrics = {k: float(v) for k, v in metrics.items()}
        s["params"], s["opt_state"] = params, opt_state
        s["updates"] = s.iteration + 1
        s["metrics"] = metrics
        bump_flops(model_flops)
        bump_tokens(float(s["built"].tokens_per_call))
        bump_steps(1.0)

    sch.schedule(train_step, bin="EVOL", thorn="trainer")

    # --- ANALYSIS: the control plane ---------------------------------------------
    # (attached above: the ControlLoop polls every registered controller from
    # the ANALYSIS bin and records each decision as an ADAPT/ row)

    # --- OUTPUT ------------------------------------------------------------------------
    def output(s: RunState) -> None:
        if logger is not None:
            logger.log(s.iteration, extra=s.get("metrics"))
        if settings.report_every and s.iteration % settings.report_every == 0:
            m = s.get("metrics") or {}
            print(
                f"[train] step {s.iteration:5d} loss={m.get('loss', float('nan')):.4f} "
                f"ce={m.get('ce', float('nan')):.4f} gnorm={m.get('grad_norm', 0):.2f}"
            )

    sch.schedule(output, bin="OUTPUT", thorn="report")

    # --- SHUTDOWN --------------------------------------------------------------------
    def shutdown(s: RunState) -> None:
        s["loader"].close()

    sch.schedule(shutdown, bin="SHUTDOWN", thorn="driver")

    # --- run -----------------------------------------------------------------------------
    # the session is entered for the duration of the run so every API that
    # defaults to timer_db() lands in the session's database
    with sess:
        sch.run(st)

    summary = {
        "iterations": st.iteration,
        "final_metrics": st.get("metrics"),
        "total_seconds": db.get("simulation/total").seconds(),
        "bin_seconds": bin_distribution(db),
        # no checkpoint is admitted, written or resumed from until the
        # checkpointing slice is ported
        "checkpoint": {},
        "ckpt_fraction": 0.0,
        "resume": None,
        "straggler_reports": len(detector.reports),
        "straggler_rows": straggler_rows(detector),
        "adapt": loop.summary(),
        "adapt_rows": adapt_rows(loop),
        # the hierarchical profile: nested inclusive/exclusive rows derived
        # from the scope stack (simulation/total → bins → routines → scopes)
        "timer_tree": tree_rows(db),
    }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="train the published width (default: the smoke config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--report", action="store_true", help="print the timer report")
    ap.add_argument("--monitor-port", type=int, default=None)
    ap.add_argument("--metrics-textfile", default=None)
    ap.add_argument("--pipeline-stages", type=int, default=0)
    ap.add_argument("--attn-impl", choices=["naive", "chunked", "pallas"], default=None,
                    help="attention implementation; 'pallas' = the CUDA flash kernels")
    ap.add_argument("--norm-impl", choices=["ref", "fused"], default=None,
                    help="rmsnorm implementation; 'fused' = the CUDA RMSNorm kernels")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    settings = TrainSettings(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir, peak_lr=args.lr,
        monitor_port=args.monitor_port,
        metrics_textfile=args.metrics_textfile,
        pipeline_stages=args.pipeline_stages,
        device=args.device, attn_impl=args.attn_impl, norm_impl=args.norm_impl,
    )
    sess = TimingSession(timer_db())
    summary = run_training(settings, session=sess)
    print(json.dumps(summary, indent=1, default=str))
    if args.report:
        # fleet-health DIST/host rows and aggregate ADAPT/ counts are already
        # in the DB; the session's control loop supplies the decision log and
        # the tree report adds the hierarchical self-vs-children view
        print(format_report(
            sess.db, channels=("walltime", "cputime", "xla_flops"),
            adapt=sess.control_loop,
        ))
        print()
        print(format_tree_report(sess.db))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
