"""Training launcher of the PyTorch port: the scheduler-driven loop with the
full timing infrastructure, the unified runtime-adaptation control plane,
restart, and monitoring.

Every lifecycle phase is a scheduled routine in a Cactus-style bin, so the
timer database holds a complete profile with zero manual instrumentation.
All runtime adaptation goes through ONE :class:`repro_torch.adapt.ControlLoop`
polled from the ANALYSIS bin: AdaptCheck checkpoint admission (paper §3.2,
via :class:`repro_torch.adapt.CheckpointControl`) and straggler response
(:class:`repro_torch.adapt.StragglerResponse` over the cross-host step-time
reduction).  Every decision lands in the ``ADAPT/`` section of the timer
report.  With ``--ckpt-dir`` the run restores the newest valid checkpoint
(onto ``--device``) and writes what AdaptCheck admits; ``--monitor-port``
serves ``/metrics``, ``/checkpoints`` and the timer views over HTTP.

``--full`` trains the published width of the architecture (default: its
smoke config); ``--attn-impl pallas --norm-impl fused`` select the
hand-written flash-attention and RMSNorm kernels, whose backward kernels the
loss then differentiates through.  Every ported family trains: dense
(llama3.2-1b, ...), hybrid (recurrentgemma-9b: RG-LRU and local attention at
head_dim 256), SSM (rwkv6-1.6b: WKV-6), MoE (moonshot-v1-16b-a3b: the
routers' load-balancing loss joins the loss as ``aux_coef * aux``), vlm
(internvl2-26b: each batch's 256 patch embeddings run in front of its
``seq_len`` text tokens, and the loss, the ``tokens`` counter and the
6 · active params · tokens FLOP count read the text tokens alone) and
encdec (seamless-m4t-large-v2: each batch's ``seq_len`` source frames run
through the 24-layer encoder, whose output every decoder layer attends to,
and the gradient flows back through it); the
recurrences train through the config's ``seq_impl="parallel"`` (the
associative scan and chunked WKV-6 in PyTorch), as the reference's blocks
train through their jnp forms.
The step runs on ``--device`` (default ``cuda``); ``--device cpu`` runs the
kernels' plain versions.

``--pipeline-stages N`` trains through the 1F1B pipeline schedule over an
N-rank ``pod`` mesh: the synthetic residual-MLP stack by default
(``--pipeline-layers``/``--pipeline-width``), or with ``--pipeline-model``
the architecture's own transformer stack, one block-pattern period per
stage slot, embedding and head pinned to the end ranks, the kernels inside
the stages.  ``--pipeline-micro`` sets the microbatch count; the phases are
timed as ``train/pipeline/{warmup,steady,cooldown}``, and a straggler that
owns a stage is answered by moving the stage boundary (``restage``), which
the next step runs.  In one process (the single controller) the N ranks are
N cards (on ``--device cpu`` they share the host).  Under a process group
of N processes (``torchrun --nproc-per-node N``) each process is one rank:
it holds only its stage's units, its pinned pieces and their optimizer
state, and the rings are point-to-point messages.  Ranks have a card each
(NCCL) unless ``--allow-shared-card`` lets them share one (gloo, the
messages staged through host memory).  Rank 0 leads: it prints, saves,
decides the straggler response and sends its stage weights to every rank
before the step they apply to; a restage moves units, with their optimizer
state, between processes; and a checkpoint gathers the whole state onto
rank 0 in the single controller's flat layout, so a save restores into any
stage count, in processes or in one.

``--mesh D,M`` trains on a ``("data", "model")`` DeviceMesh of ``D * M``
processes (``torchrun --nproc-per-node D*M``), the parameters, optimizer
state and batch sharded by the config's logical axes under its preset
(``cfg.sharding``: ``tp`` puts heads, KV heads, FFN, experts and vocabulary
over ``model`` and the batch over ``data``; ``tp+fsdp`` the parameters'
embedding width over ``data`` too).  Every rank draws the same parameters
and batches from the seed and keeps its own shards; the flash and RMSNorm
kernels run on each rank's local shards.  Rank 0 alone writes the log, the status file, the
``/metrics`` export and the checkpoints; a save gathers the full tensors
(every rank takes part) and writes what an unsharded run writes, and a
restore shards what it loads, so a run resumes on any mesh.  Ranks have a
card each (NCCL) unless ``--allow-shared-card`` lets them share one (gloo).

    PYTHONPATH=src python -m repro_torch.launch.train --full --arch llama3.2-1b \\
        --attn-impl pallas --norm-impl fused --steps 6 --batch 4 --seq 1024 --report
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch rwkv6-1.6b \\
        --attn-impl pallas --norm-impl fused --steps 6 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch seamless-m4t-large-v2 \\
        --attn-impl pallas --norm-impl fused --steps 6 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 8 \\
        --batch 2 --seq 32 --ckpt-dir /tmp/ckpt --ckpt-mode fixed --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --full --pipeline-stages 1 \\
        --pipeline-model --pipeline-micro 4 --attn-impl pallas --norm-impl fused \\
        --steps 4 --batch 4 --seq 1024
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2,2 --steps 4 --batch 4 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --pipeline-stages 2 --pipeline-model --pipeline-micro 4 \\
        --steps 4 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import time
from typing import Any

import numpy as np
import torch

from ..adapt import CheckpointControl, ControlLoop, StragglerResponse
from ..checkpoint import CheckpointManager, load_checkpoint, plan_resume
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core import (
    AdaptiveCheckpointController,
    AdaptiveCheckpointPolicy,
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
from ..core.clocks import CounterClock, register_clock, resolve_device_events
from ..data import DataLoader, SyntheticConfig, SyntheticLM
from ..dist import collectives, p2p
from ..dist.meshutil import device_mesh, init_process_group, local_mesh
from ..dist.sharding import Axes, distribute_tree, gather_tree
from ..dist.pipeline import MicrobatchPlan, StagePlan, phase_ticks
from ..dist.stragglers import StragglerDetector
from ..fleet.topology import stage_for_host
from ..kernels import build
from ..models import model as M, pipeline as model_pipeline
from ..models.config import ArchConfig, ShapeConfig
from ..monitor import MetricsExporter, MonitorServer, StatusWriter
from ..optim import AdamWConfig, init_opt_state
from ..timing import TimingSession
from .steps import (
    batch_axes,
    make_pipeline_train_step,
    make_train_step,
    make_transformer_pipeline_train_step,
    rules_for,
)

__all__ = ["TrainSettings", "run_training", "main"]


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
    ckpt_synchronous: bool = False
    ckpt_delay_s: float = 0.0            # injected write latency (experiments)
    ckpt_keep_n: int = 3                 # retention: keep the newest N
    ckpt_keep_every_k: int = 0           # retention: also keep step % k == 0
    #: preemption grace period: SIGTERM triggers a deadline-bounded emergency
    #: save through the manager's chained handler (None installs no deadline)
    save_deadline_s: float | None = None
    queue_seconds: float | None = None
    #: kept for the reference's settings; no code reads it, as in the reference
    eval_every: int = 0
    report_every: int = 25
    log_path: str | None = None
    status_path: str | None = None
    monitor_port: int | None = None
    #: Prometheus textfile-collector path: the exporter page is atomically
    #: rewritten on the report cadence and at shutdown (node_exporter style)
    metrics_textfile: str | None = None
    #: resume from the newest valid checkpoint in ``ckpt_dir`` when one exists
    restore: bool = True
    seed: int = 0
    data_mode: str = "copy"
    #: LR-schedule horizon; decoupled from `steps` so an interrupted run and
    #: its resumption share the same schedule (restart determinism)
    lr_total_steps: int | None = None
    #: pipeline-parallel (1F1B) training path: 0 = off; N > 0 pipelines the
    #: stages over an N-rank "pod" mesh; 1 still runs the full tick schedule.
    #: In one process the ranks are N cards on "cuda" (they share the host
    #: on "cpu"); under a process group of N processes each is one rank (a
    #: card each, or sharing with allow_shared_card)
    pipeline_stages: int = 0
    pipeline_layers: int = 8          # homogeneous stage-stack depth (MLP path)
    pipeline_micro: int = 4           # 1F1B microbatch count
    pipeline_width: int = 32          # stage activation width (MLP path)
    #: pipeline the real transformer (cfg's block stack; one pattern period
    #: per slot, embed/head pinned to the end ranks) instead of the
    #: synthetic residual-MLP stack
    pipeline_model: bool = False
    #: where the step runs; the kernels need "cuda", "cpu" runs their plain versions
    device: str = "cuda"
    #: config overrides (None keeps the config's value)
    attn_impl: str | None = None
    norm_impl: str | None = None
    #: ("data", "model") mesh of processes; more than one rank needs a process
    #: group of that size (torchrun, or one the caller initialized)
    mesh_shape: tuple[int, ...] = (1, 1)
    #: let more ranks (sharded or pipelined processes) than cards share
    #: them (gloo instead of NCCL)
    allow_shared_card: bool = False


def _flops_per_step(cfg: ArchConfig, tokens: int) -> float:
    _, active = M.param_counts(cfg)
    return 6.0 * active * tokens


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

    ``pipeline_stages`` runs the single controller in one process, or, with
    an initialized process group (or ``WORLD_SIZE`` > 1 in the environment,
    as ``torchrun`` sets it), one process a stage: the group's world must be
    ``pipeline_stages``.  Under a process group rank 0 alone logs, prints,
    saves and decides; the summary is each rank's own.
    """
    if cfg is None:
        cfg = get_smoke_config(settings.arch) if settings.smoke else get_config(settings.arch)
    overrides = {"attn_impl": settings.attn_impl, "norm_impl": settings.norm_impl}
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    pipelined = settings.pipeline_stages > 0
    sharded = math.prod(settings.mesh_shape) > 1
    if sharded and pipelined:
        raise ValueError("mesh_shape and pipeline_stages do not combine: the pipeline's "
                         "stages compute on whole stage parameters")
    # the sharded path: a DeviceMesh over the process group; rank 0 leads
    dmesh = _device_mesh(settings) if sharded else None
    rules = rules_for(cfg)
    calls0, bytes0 = dict(collectives.COUNTS), dict(collectives.BYTES)
    sends0, sent0 = dict(p2p.COUNTS), dict(p2p.BYTES)
    # the 1F1B path pipelines homogeneous stages over a dedicated pod axis:
    # one process a stage under a process group, else the single controller
    procs = pipelined and _pipeline_processes(settings)
    if procs:
        mesh = device_mesh((settings.pipeline_stages,), ("pod",), settings.device,
                           allow_shared_card=settings.allow_shared_card)
    elif pipelined:
        mesh = local_mesh((settings.pipeline_stages,), ("pod",), settings.device)
    else:
        mesh = None
    # under a process group rank 0 leads: logs, prints, saves and decides
    group = sharded or procs
    lead = not group or torch.distributed.get_rank() == 0
    sess = (
        session
        if session is not None
        else TimingSession(timer_db(), control_loop=control_loop)
    )
    db = sess.db
    registry = param_registry()
    sch = sess.scheduler
    st = RunState(max_iterations=settings.steps)
    # checkpoint-label convention: every save is labeled with the number of
    # optimizer updates applied — i.e. the next iteration to execute — so a
    # resume (`s.iteration = label; DataLoader(start_step=label)`) replays the
    # trajectory exactly.  The CHECKPOINT bin of iteration i runs *after*
    # EVOL applied update i, so its label is i + 1, never i.
    st["updates"] = 0

    device = torch.device(settings.device)
    if device.type == "cuda" and group:  # the card device_mesh gave this rank
        device = torch.device("cuda", torch.cuda.current_device())
    shape = ShapeConfig("train_local", "train", settings.seq_len, settings.global_batch)

    registry.declare("ckpt.max_fraction", settings.ckpt_max_fraction, steerable=True,
                     doc="AdaptCheck wall-time fraction bound")
    registry.declare("ckpt.max_interval_s", settings.ckpt_max_interval_s, steerable=True,
                     doc="AdaptCheck max seconds between checkpoints")

    # --- thorn state shared across routines -------------------------------------
    manager = None
    monitor = None
    logger = TimerLogger(settings.log_path, db) if settings.log_path and lead else None
    status = StatusWriter(settings.status_path, db) if settings.status_path and lead else None
    if pipelined and not settings.pipeline_model:
        # the MLP pipeline path trains the residual-MLP stage stack, not the
        # transformer cfg: same 6 * active-params * tokens convention, with
        # the stack's actual parameter count (n_layers x 2 W x W matmuls)
        active = settings.pipeline_layers * 2 * settings.pipeline_width ** 2
        model_flops = 6.0 * active * settings.global_batch * settings.seq_len
    else:
        model_flops = _flops_per_step(cfg, settings.global_batch * settings.seq_len)

    # --- the control plane: one loop, every adaptation registered on it ----------
    ckpt_timer_name = "CHECKPOINT/adaptcheck::write"
    ckpt_write_scope = sess.scope_handle(ckpt_timer_name)
    loop = sess.control_loop
    policy = AdaptiveCheckpointPolicy(
        mode="adaptive" if settings.ckpt_mode == "adaptive" else "fixed",
        every_iterations=settings.ckpt_every,
        max_fraction=registry.get("ckpt.max_fraction"),
        max_interval_seconds=registry.get("ckpt.max_interval_s"),
        queue_seconds=settings.queue_seconds,
    )
    controller = AdaptiveCheckpointController(policy)
    ckpt_control = CheckpointControl(
        controller, ckpt_timer=ckpt_timer_name, registry=registry
    )
    ckpt_active = bool(settings.ckpt_dir) and settings.ckpt_mode != "off"
    if ckpt_active and lead:  # the other ranks follow rank 0's admissions
        loop.register(ckpt_control)

    def topology_meta() -> dict[str, Any]:
        """Topology block stamped into every checkpoint's metadata — what a
        resume into a *different* stage count re-apportions from."""
        if not pipelined:
            return {}
        return {
            "topology": {
                "n_layers": stage_plan.n_layers,
                "n_micro": settings.pipeline_micro,
                "stage_weights": {
                    int(k): float(v) for k, v in stage_plan.weights.items()
                },
            }
        }

    def current_state() -> dict[str, Any]:
        """The state a checkpoint holds; under a mesh, full tensors gathered
        from every rank (a collective: every rank calls it together); of
        pipeline processes, the whole tree and state on rank 0's host
        (``None`` elsewhere)."""
        if procs:
            params, opt_state = st["built"].share.gather(st["params"], st["opt_state"])
        elif sharded:
            params, opt_state = gather_tree(st["params"]), gather_tree(st["opt_state"])
        else:
            params, opt_state = st["params"], st["opt_state"]
        return {"params": params, "opt_state": opt_state, "data": st["loader"].state()}

    def durable_save(step: int) -> float:
        """Checkpoint-before-evict: write AND wait until durable (the barrier
        contract — an eviction must never outrun its safety checkpoint)."""
        if manager is None:
            raise RuntimeError("no checkpoint manager bound")
        t0 = time.monotonic()
        with ckpt_write_scope:
            # labeled with the update count, not the adapt step: the barrier
            # fires post-EVOL, so the state on disk is the start-of-step state
            # for update `st["updates"]` (see adaptive_checkpoint)
            manager.save(
                st["updates"], current_state(),
                metadata={"reason": "before_evict", **topology_meta()},
            )
            manager.wait()
        return time.monotonic() - t0

    if ckpt_active and not group:
        # a save under a process group is a collective, which an eviction
        # barrier on one rank cannot start
        ckpt_control.bind_durable_save(durable_save)
    if ckpt_active and not settings.ckpt_synchronous:
        def final_save_margin(step: int) -> float | None:
            """Seconds by which a write started at step ``step`` would land
            before SHUTDOWN's final save: the steps left at the mean step so
            far, less the last write's seconds (None before both exist)."""
            if (manager is None or not manager.last_write_seconds
                    or not db.exists("EVOL/trainer::train_step")):
                return None
            evol = db.get("EVOL/trainer::train_step")
            left = (settings.steps - step - 1) * evol.seconds() / max(evol.count, 1)
            return left - manager.last_write_seconds

        ckpt_control.bind_final_save(final_save_margin)
    # single-process topology: this host feeds its own EVOL step timer into
    # the reduction; multi-host launchers hand the detector a transport.  On
    # the pipeline path the response controller additionally owns the
    # StagePlan, so a confirmed straggler that owns a stage is answered by
    # moving the stage boundary (restage) before any microbatch derate.
    pipeline_units = (
        model_pipeline.check_pipelineable(cfg)
        if pipelined and settings.pipeline_model
        else settings.pipeline_layers
    )
    stage_plan = (
        StagePlan.equal(range(settings.pipeline_stages), pipeline_units)
        if pipelined
        else None
    )
    detector = StragglerDetector(n_hosts=1, db=db)
    # pipeline processes follow rank 0's response: its stage weights reach
    # every rank before the step they apply to (train_step)
    if not procs or lead:
        loop.register(
            StragglerResponse(
                detector,
                MicrobatchPlan.equal([0], n_micro=1),
                check_every=8,
                local_feed=(0, "EVOL/trainer::train_step"),
                stage_plan=stage_plan,
                # stage ownership derived from membership coordinates, not
                # hard-coded: one live host on an S-stage pipeline owns stage 0
                # (the rest ride along in-process)
                stage_for_host=(
                    stage_for_host([0], settings.pipeline_stages) if pipelined else None
                ),
                evict_barrier=ckpt_control.evict_barrier if ckpt_active and not group else None,
            )
        )
    sch.attach_control_loop(loop, bin="ANALYSIS")
    # one exporter for both surfaces: the monitor's /metrics endpoint and the
    # optional textfile written on the report cadence
    exporter = MetricsExporter(
        db, control_loop=loop, detector=detector,
        checkpoint_fn=lambda: manager.status_payload() if manager is not None else {},
    )
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
        nonlocal manager, monitor
        opt_cfg = AdamWConfig()
        horizon = settings.lr_total_steps or settings.steps
        schedule = dict(peak_lr=settings.peak_lr, total_steps=max(horizon, 2),
                        warmup_steps=max(min(100, horizon // 10), 1))
        if pipelined:
            # each schedule phase is a separately synchronized segment
            # recorded under its own timing scope
            phase_handles = {
                name: sess.scope_handle(f"train/pipeline/{name}")
                for name in phase_ticks(settings.pipeline_micro, settings.pipeline_stages)
            }
            common = dict(seq_len=settings.seq_len, global_batch=settings.global_batch,
                          n_micro=settings.pipeline_micro, opt_cfg=opt_cfg, seed=settings.seed,
                          phase_cb=lambda name: phase_handles[name], device=device,
                          **schedule)
            if settings.pipeline_model:
                built = make_transformer_pipeline_train_step(cfg, mesh, stage_plan, **common)
            else:
                built = make_pipeline_train_step(mesh, stage_plan, width=settings.pipeline_width,
                                                 vocab_size=cfg.vocab_size, **common)
        else:
            built = make_train_step(cfg, shape, opt_cfg=opt_cfg, mesh=dmesh, rules=rules,
                                    **schedule)
        s["built"] = built
        # the pipeline's fn re-packs the live StagePlan every step
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
        start_step = 0
        restored = None
        if settings.ckpt_dir and group:
            restored = _restore_sharded(settings, lead, sess)
            if lead:
                manager = CheckpointManager(
                    settings.ckpt_dir, keep_n=settings.ckpt_keep_n,
                    keep_every_k=settings.ckpt_keep_every_k,
                    synchronous=settings.ckpt_synchronous, delay_s=settings.ckpt_delay_s,
                )
        elif settings.ckpt_dir:
            manager = CheckpointManager(
                settings.ckpt_dir,
                keep_n=settings.ckpt_keep_n,
                keep_every_k=settings.ckpt_keep_every_k,
                synchronous=settings.ckpt_synchronous,
                delay_s=settings.ckpt_delay_s,
            )
            if settings.restore:
                # validation (the streamed re-hash) and the load onto the device
                with sess.scope_handle("STARTUP/restore"):
                    restored = manager.restore_latest(device=device)
        if restored is not None:
            start_step, tree, meta = restored
            s["params"] = tree["params"]
            s["opt_state"] = tree["opt_state"]
            if sharded:  # loaded whole on the host: each rank keeps its shards
                s["params"], s["opt_state"] = _shard_state(cfg, opt_cfg, dmesh, rules, device,
                                                           s["params"], s["opt_state"])
            s.iteration = start_step
            s["updates"] = start_step
            topo = (meta or {}).get("topology")
            if pipelined and topo and int(topo.get("n_layers", -1)) == stage_plan.n_layers:
                # N->M topology restore: re-apportion the saved stage capacity
                # weights onto the *current* stage set.  The parameter stack is
                # flat per-layer, so adopting the retargeted weights in place
                # is all it takes — the next step's pack() splits the same
                # layers along the new boundaries.  (Manifest JSON stringifies
                # the stage keys; convert back.)
                saved = StagePlan(
                    n_layers=stage_plan.n_layers,
                    weights={int(k): float(v) for k, v in topo["stage_weights"].items()},
                )
                adopted = saved.retarget(range(settings.pipeline_stages))
                stage_plan.weights.clear()
                stage_plan.weights.update(adopted.weights)
            if procs:  # loaded whole on the host: each rank keeps its share
                s["params"], s["opt_state"] = built.share.adopt(s["params"], s["opt_state"])
                del tree
            if lead:
                print(f"[train] restored checkpoint at step {start_step}")
        else:
            with sess.scope_handle("STARTUP/init_params"):
                generator = torch.Generator(device=device).manual_seed(settings.seed)
                if pipelined:
                    s["params"] = built.init_params(generator)
                else:
                    s["params"] = M.init_params(cfg, generator, device)
                if sharded:  # every rank drew the same weights: keep its shards
                    s["params"] = distribute_tree(s["params"], M.param_axes(cfg), dmesh, rules)
                s["opt_state"] = init_opt_state(opt_cfg, s["params"])
        s["loader"] = DataLoader(source, start_step=start_step)

        if manager is not None and not group:
            # (a save under a process group is a collective, which a signal
            # on one rank cannot start: such runs install no SIGTERM save)
            # installed only once live state exists — a preemption mid-restore
            # has nothing durable to add anyway.  The label is the number of
            # optimizer updates applied so far, which is exact no matter where
            # in the scheduler cycle the signal lands.
            s["sigterm_before"] = signal.getsignal(signal.SIGTERM)
            try:
                manager.install_sigterm_handler(
                    lambda: (st["updates"], current_state()),
                    deadline_s=settings.save_deadline_s,
                )
            except ValueError:
                # not the main thread: signals unavailable, skip the hook
                s["sigterm_before"] = None

        ckpt_control.start_run(time.monotonic())
        if settings.monitor_port is not None and lead:
            monitor = MonitorServer(settings.monitor_port, db, registry,
                                    status_fn=lambda: {"iteration": st.iteration},
                                    checkpoint_fn=(
                                        manager.status_payload
                                        if manager is not None else None
                                    ),
                                    exporter=exporter)
            port = monitor.start()
            print(f"[train] monitor at http://127.0.0.1:{port}/")
        registry.freeze()

    sch.schedule(startup, bin="STARTUP", thorn="driver")

    # --- PRESTEP: data ------------------------------------------------------------
    in_axes = {k: Axes(v) for k, v in batch_axes(cfg, "train").items()}

    def fetch_data(s: RunState) -> None:
        batch = s["loader"].next()
        s["batch"] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in batch.items()}
        if sharded:  # every rank loaded the same global batch: keep its rows
            s["batch"] = distribute_tree(s["batch"], in_axes, dmesh, rules)

    sch.schedule(fetch_data, bin="PRESTEP", thorn="data")

    # --- EVOL: the training step ------------------------------------------------------
    def train_step(s: RunState) -> None:
        if procs:  # rank 0's stage weights, on every rank (a restage moves units)
            _agree_weights(stage_plan)
        params, opt_state, metrics = s["exec"](s["params"], s["opt_state"], s["batch"])
        # reading the metrics back waits for the device: the EVOL timer holds
        # the step's device time, and the step's device-event pairs are done
        metrics = {k: float(v) for k, v in metrics.items()}
        resolve_device_events()
        s["params"], s["opt_state"] = params, opt_state
        s["updates"] = s.iteration + 1
        s["metrics"] = metrics
        bump_flops(model_flops)
        bump_tokens(float(s["built"].tokens_per_call))
        bump_steps(1.0)

    sch.schedule(train_step, bin="EVOL", thorn="trainer")

    # --- ANALYSIS: the control plane ---------------------------------------------
    # (attached above: the ControlLoop polls every registered controller from
    # the ANALYSIS bin — AdaptCheck steering + decision, straggler reduction +
    # response — and records each decision as an ADAPT/ row)

    # --- CHECKPOINT: consume the AdaptCheck admission ------------------------------
    def adaptive_checkpoint(s: RunState) -> None:
        if not ckpt_active:
            return
        # decision was made (with live-steered policy) at this iteration's
        # ANALYSIS poll; this routine only performs the admitted write
        decision = ckpt_control.take_decision() if lead else None
        s["last_ckpt_decision"] = decision
        admitted = decision is not None and decision.checkpoint
        if group:  # rank 0's admission, on every rank: the save gathers
            admitted = _agree(admitted)
        if not admitted:
            return
        state = current_state()
        if not lead:
            return
        with ckpt_write_scope:
            stats = manager.save(
                s["updates"],
                state,
                metadata={"reason": decision.reason, **topology_meta()},
            )
        ckpt_control.observe_checkpoint(stats["blocking_seconds"], stats["nbytes"])

    sch.schedule(adaptive_checkpoint, bin="CHECKPOINT", thorn="adaptcheck")

    # --- OUTPUT ------------------------------------------------------------------------
    def output(s: RunState) -> None:
        if logger is not None:
            logger.log(s.iteration, extra=s.get("metrics"))
        if status is not None:
            status.write({"iteration": s.iteration, **(s.get("metrics") or {})})
        if settings.report_every and s.iteration % settings.report_every == 0 and lead:
            if settings.metrics_textfile:
                exporter.write_textfile(settings.metrics_textfile)
            m = s.get("metrics") or {}
            print(
                f"[train] step {s.iteration:5d} loss={m.get('loss', float('nan')):.4f} "
                f"ce={m.get('ce', float('nan')):.4f} gnorm={m.get('grad_norm', 0):.2f}"
            )

    sch.schedule(output, bin="OUTPUT", thorn="report")

    # --- SHUTDOWN --------------------------------------------------------------------
    def shutdown(s: RunState) -> None:
        final = bool(settings.ckpt_dir) and settings.ckpt_mode != "off"
        state = current_state() if final and group else None  # every rank gathers
        if manager is not None and settings.ckpt_mode != "off":
            with ckpt_write_scope:
                manager.save(
                    s["updates"],
                    state if state is not None else current_state(),
                    metadata={"reason": "final", **topology_meta()},
                )
            manager.wait()
        if manager is not None:
            manager.close()
            if s.get("sigterm_before") is not None:
                # the run's state is gone: a later SIGTERM must not save it
                signal.signal(signal.SIGTERM, s["sigterm_before"])
        s["loader"].close()
        if settings.metrics_textfile and lead:
            exporter.write_textfile(settings.metrics_textfile)
        if monitor is not None:
            monitor.stop()

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
        "checkpoint": controller.summary(),
        "ckpt_fraction": (
            ckpt_write_scope.seconds() / max(db.get("simulation/total").seconds(), 1e-9)
        ),
        # the resume picture the run started from (None on a cold start):
        # which checkpoints validated, which were quarantined and why
        "resume": (
            manager.last_resume_plan.summary()
            if manager is not None and manager.last_resume_plan is not None
            else None
        ),
        "straggler_reports": len(detector.reports),
        "straggler_rows": straggler_rows(detector),
        "adapt": loop.summary(),
        "adapt_rows": adapt_rows(loop),
        # the hierarchical profile: nested inclusive/exclusive rows derived
        # from the scope stack (simulation/total → bins → routines → scopes)
        "timer_tree": tree_rows(db),
    }
    if sharded:
        summary["mesh"] = {
            "shape": tuple(settings.mesh_shape),
            "axes": tuple(dmesh.mesh_dim_names),
            "sharding": cfg.sharding,
            "rank": torch.distributed.get_rank(),
            "backend": torch.distributed.get_backend(),
            # this run's routed collectives of a gloo mesh (none under NCCL)
            "collective_calls": {k: v - calls0[k] for k, v in collectives.COUNTS.items()},
            "collective_bytes": {k: v - bytes0[k] for k, v in collectives.BYTES.items()},
            "collective_seconds": collectives.collective_seconds(db),
        }
    if pipelined:
        summary["pipeline"] = {
            "n_stages": settings.pipeline_stages,
            "n_layers": stage_plan.n_layers,
            "workload": cfg.name if settings.pipeline_model else "mlp",
            "n_micro": settings.pipeline_micro,
            "depths": stage_plan.depths(),
            "phase_seconds": {
                name: (
                    db.get(f"train/pipeline/{name}").seconds()
                    if db.exists(f"train/pipeline/{name}")
                    else 0.0
                )
                for name in phase_ticks(settings.pipeline_micro, settings.pipeline_stages)
            },
            "mode": "processes" if procs else "controller",
        }
        if procs:
            # every rank's own phase seconds, and this rank's messages
            ranks = [None] * settings.pipeline_stages
            torch.distributed.all_gather_object(ranks, summary["pipeline"]["phase_seconds"])
            summary["pipeline"].update({
                "rank": torch.distributed.get_rank(),
                "backend": torch.distributed.get_backend(),
                "rank_phase_seconds": ranks,
                "p2p_calls": {k: v - sends0[k] for k, v in p2p.COUNTS.items()},
                "p2p_bytes": {k: v - sent0[k] for k, v in p2p.BYTES.items()},
                "p2p_seconds": p2p.p2p_seconds(db),
            })
    return summary


def _device_mesh(settings: TrainSettings):
    """The ("data", "model") DeviceMesh of a sharded run, starting the
    process group from the environment when the caller has not."""
    if not torch.distributed.is_initialized():
        init_process_group(settings.device)
    names = ("data", "model") if len(settings.mesh_shape) == 2 else None
    return device_mesh(settings.mesh_shape, names, settings.device,
                       allow_shared_card=settings.allow_shared_card)


def _pipeline_processes(settings: TrainSettings) -> bool:
    """Whether the pipeline runs one process a stage: under an initialized
    process group, or one the environment describes (``torchrun``), which
    is started here; its world must be ``pipeline_stages``."""
    dist = torch.distributed
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_process_group(settings.device)
    if not dist.is_initialized():
        return False
    if dist.get_world_size() != settings.pipeline_stages:
        raise ValueError(
            f"pipeline_stages={settings.pipeline_stages} but the process group has "
            f"{dist.get_world_size()} ranks: under a process group the pipeline runs one "
            f"process a stage, so pipeline_stages must be the world size")
    return True


def _agree(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank."""
    box = [bool(flag)]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _agree_weights(plan: StagePlan) -> None:
    """Rank 0's stage weights, adopted in place by ``plan`` on every rank."""
    box = [dict(plan.weights)]
    torch.distributed.broadcast_object_list(box, src=0)
    plan.weights.clear()
    plan.weights.update(box[0])


def _restore_sharded(settings: TrainSettings, lead: bool, sess: TimingSession):
    """(step, tree on the host, metadata) of the newest valid checkpoint, or
    None, on every rank: rank 0 validates (and quarantines) as an unsharded
    run does and names the directory, and every rank maps it, reading only
    what it keeps."""
    with sess.scope_handle("STARTUP/restore"):
        path = None
        if lead and settings.restore:
            plan = plan_resume(settings.ckpt_dir, quarantine=True)
            path = plan.valid[0].path if plan.valid else None
        box = [path]
        torch.distributed.broadcast_object_list(box, src=0)
        return load_checkpoint(box[0], verify=False, mmap=True) if box[0] is not None else None


def _shard_state(cfg, opt_cfg, mesh, rules, device, params, opt_state):
    """A whole (params, opt_state) loaded on the host, as this rank's
    shards on ``device``: the moments and master weights take their
    parameters' placements; the step counter stays a plain tensor."""
    p_axes = M.param_axes(cfg)
    params = distribute_tree(params, p_axes, mesh, rules, device=device)
    state = {"step": opt_state["step"].to(device)}
    for key in ("m", "v", "master"):
        if key in opt_state:
            state[key] = distribute_tree(opt_state[key], p_axes, mesh, rules, device=device)
    return params, state


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
    ap.add_argument("--ckpt-mode", choices=["adaptive", "fixed", "off"], default="adaptive")
    ap.add_argument("--ckpt-every", type=int, default=512)
    ap.add_argument("--ckpt-max-fraction", type=float, default=0.05)
    ap.add_argument("--ckpt-sync", action="store_true")
    ap.add_argument("--keep-n", type=int, default=3,
                    help="retention: keep the newest N checkpoints")
    ap.add_argument("--keep-every-k", type=int, default=0,
                    help="retention: additionally keep every k-th step (0 = off)")
    ap.add_argument("--save-deadline", type=float, default=None,
                    help="SIGTERM grace period (s) for the emergency save")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--report", action="store_true", help="print the timer report")
    ap.add_argument("--monitor-port", type=int, default=None)
    ap.add_argument("--metrics-textfile", default=None,
                    help="write the Prometheus exposition here on the report "
                         "cadence (textfile-collector scrape path)")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="1F1B pipeline-parallel path: pod-axis size (0 = off); in one "
                         "process N cards (the host's CPU ranks on --device cpu), under "
                         "torchrun --nproc-per-node N one process a stage")
    ap.add_argument("--pipeline-layers", type=int, default=8)
    ap.add_argument("--pipeline-micro", type=int, default=4)
    ap.add_argument("--pipeline-width", type=int, default=32)
    ap.add_argument("--pipeline-model", action="store_true",
                    help="pipeline the real transformer stack (one block-pattern "
                         "period per stage slot, embed/head pinned to the end "
                         "ranks) instead of the synthetic residual-MLP stack")
    ap.add_argument("--attn-impl", choices=["naive", "chunked", "pallas"], default=None,
                    help="attention implementation; 'pallas' = the CUDA flash kernels")
    ap.add_argument("--norm-impl", choices=["ref", "fused"], default=None,
                    help="rmsnorm implementation; 'fused' = the CUDA RMSNorm kernels")
    ap.add_argument("--mesh", default="1,1",
                    help="D,M: train on a (data, model) mesh of D*M processes "
                         "(torchrun --nproc-per-node D*M)")
    ap.add_argument("--allow-shared-card", action="store_true",
                    help="let more ranks (--mesh or --pipeline-stages processes) than "
                         "cards share them (gloo instead of NCCL)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    settings = TrainSettings(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_mode=args.ckpt_mode, ckpt_every=args.ckpt_every,
        ckpt_max_fraction=args.ckpt_max_fraction,
        ckpt_synchronous=args.ckpt_sync, peak_lr=args.lr,
        ckpt_keep_n=args.keep_n, ckpt_keep_every_k=args.keep_every_k,
        save_deadline_s=args.save_deadline,
        monitor_port=args.monitor_port,
        metrics_textfile=args.metrics_textfile,
        pipeline_stages=args.pipeline_stages,
        pipeline_layers=args.pipeline_layers,
        pipeline_micro=args.pipeline_micro,
        pipeline_width=args.pipeline_width,
        pipeline_model=args.pipeline_model,
        device=args.device, attn_impl=args.attn_impl, norm_impl=args.norm_impl,
        mesh_shape=tuple(int(n) for n in args.mesh.split(",")),
        allow_shared_card=args.allow_shared_card,
    )
    sess = TimingSession(timer_db())
    summary = run_training(settings, session=sess)
    if torch.distributed.is_initialized():
        rank = torch.distributed.get_rank()
        torch.distributed.destroy_process_group()
        if rank:  # rank 0 prints the run; every rank kept its own timers
            return 0
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
