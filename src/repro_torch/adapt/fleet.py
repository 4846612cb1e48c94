"""A simulated multi-host fleet for closing the adapt loop in tests and drills.

Real deployments run one process per host: each publishes its step walltime
through a collective-backed transport, one reducing process runs the control
loop, and eviction rebuilds the device mesh
(:func:`repro_torch.dist.meshutil.remove_host`).  :class:`SimulatedFleet`
compresses that topology into one process so the whole measure → decide →
rebalance → evict → rebuild chain is exercisable in CI:

* every simulated host "executes" its
  :class:`~repro_torch.dist.pipeline.MicrobatchPlan` share per fleet step;
  its step walltime is *synthetic* — per-microbatch cost x assigned share,
  no sleeping — so tests are fast and deterministic;
* the walltimes travel through the same injectable
  :class:`~repro_torch.dist.stragglers.LocalTransport` a real launcher would
  back with an all-gather;
* eviction triggers a mesh rebuild through :mod:`repro_torch.dist.meshutil`
  (each surviving host gets a fresh local mesh; ``mesh_generation`` counts
  rebuilds);
* optionally (``run_pipeline=True``) each host really feeds its share through
  :func:`~repro_torch.dist.pipeline.gpipe_forward` on its local mesh, proving
  the rebalanced assignment produces working pipeline calls end to end;
* with ``n_layers > 0`` the fleet becomes a **pipeline fleet**: host ``h``
  owns pipeline stage ``h`` of a shared
  :class:`~repro_torch.dist.pipeline.StagePlan` and its synthetic step time
  scales with its *stage depth* — so the straggler response answers a slow
  stage owner by moving the stage boundary (``restage``), and
  ``run_pipeline=True`` executes the restaged boundaries through a real 1F1B
  :class:`~repro_torch.dist.pipeline.PipelineStep` (packed params + slot
  mask) to prove the new split computes.

The pipeline calls' tensors live on ``device`` (default ``"cuda"``, as every
entry point of the port; tests pass ``"cpu"``).  Inject a slowdown with
:meth:`slow_host`, drive steps with :meth:`run_step`, and read convergence
off :meth:`spread`.
"""

from __future__ import annotations

import torch

from ..core.timers import TimerDB, timer_db
from ..dist.meshutil import local_mesh
from ..dist.pipeline import (
    MicrobatchPlan,
    PipelineStep,
    StagePlan,
    gpipe_forward,
)
from ..dist.stragglers import LocalTransport, StragglerDetector
from .stragglers import StragglerResponse

__all__ = ["SimulatedFleet"]


class SimulatedFleet:
    """n simulated hosts, a shared microbatch plan, and a straggler responder.

    The fleet owns the full wiring: transport -> detector -> response
    controller; register :attr:`controller` on a
    :class:`~repro_torch.adapt.controller.ControlLoop` and alternate
    ``fleet.run_step(i)`` / ``loop.poll(i)``.
    """

    def __init__(
        self,
        n_hosts: int,
        n_micro: int,
        *,
        per_micro_seconds: float = 1.0,
        window: int = 4,
        threshold: float = 1.5,
        check_every: int = 1,
        confirm_after: int = 1,
        evict_after: int = 4,
        min_weight: float = 0.25,
        db: TimerDB | None = None,
        run_pipeline: bool = False,
        micro_batch: int = 2,
        feature_dim: int = 4,
        n_layers: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.db = db if db is not None else timer_db()
        self.device = torch.device(device)
        self.transport = LocalTransport()
        self.plan = MicrobatchPlan.equal(range(n_hosts), n_micro)
        #: pipeline mode: host h owns stage h of a shared layer stack
        self.stage_plan = (
            StagePlan.equal(range(n_hosts), n_layers) if n_layers > 0 else None
        )
        self.detector = StragglerDetector(
            n_hosts,
            window=window,
            threshold=threshold,
            transport=self.transport,
            db=self.db,
        )
        self.controller = StragglerResponse(
            self.detector,
            self.plan,
            check_every=check_every,
            confirm_after=confirm_after,
            evict_after=evict_after,
            min_weight=min_weight,
            stage_plan=self.stage_plan,
            stage_for_host=(
                {h: h for h in range(n_hosts)} if self.stage_plan else None
            ),
            on_evict=self._rebuild_meshes,
            on_restage=self._on_restage,
        )
        #: per-microbatch execution cost of each host (seconds, synthetic)
        self.costs: dict[int, float] = {h: float(per_micro_seconds) for h in range(n_hosts)}
        #: nominal (fault-free) costs — what :meth:`restore_host` returns to
        self.nominal_costs: dict[int, float] = dict(self.costs)
        self.run_pipeline = run_pipeline
        self.micro_batch = micro_batch
        self.feature_dim = feature_dim
        self.evicted: list[int] = []
        self.mesh_generation = 0
        #: restage actions applied: [(host, stage, depths)]
        self.restages: list[tuple[int, int, dict[int, int]]] = []
        self.meshes: dict[int, object] = {}
        self.last_step_seconds: dict[int, float] = {}
        self._pipeline_step: PipelineStep | None = None
        self._layer_params: torch.Tensor | None = None
        self._rebuild_meshes(host=None, report=None)

    # -- environment --------------------------------------------------------------
    def slow_host(self, host: int, factor: float) -> None:
        """Inject a slowdown: host's per-microbatch cost multiplies by
        ``factor`` (a degraded node, thermal throttling, a noisy neighbor)."""
        if host not in self.costs:
            raise ValueError(f"unknown host {host}")
        self.costs[host] *= float(factor)

    def hang_host(self, host: int, factor: float = 1000.0) -> None:
        """Inject a (near-)hang: the host still answers the transport but its
        steps take ``factor``× nominal — a wedged accelerator or livelocked
        rank.  Finite on purpose: the reduction still sees samples, so the
        response policy (derate → evict backstop) is what ends the stall."""
        if host not in self.costs:
            raise ValueError(f"unknown host {host}")
        self.costs[host] = self.nominal_costs[host] * float(factor)

    def restore_host(self, host: int) -> None:
        """Clear injected degradation: cost returns to nominal (the fault —
        noisy neighbor, thermal throttle — passed)."""
        if host not in self.costs:
            raise ValueError(f"unknown host {host}")
        self.costs[host] = self.nominal_costs[host]

    # -- one fleet step ------------------------------------------------------------
    def run_step(self, step: int) -> dict[int, float]:
        """Execute one fleet step: every active host runs its assignment and
        publishes its (synthetic) walltime through the transport.  Returns
        {host: step seconds}.

        Data-parallel mode: a host's work is its microbatch share.  Pipeline
        mode (``n_layers > 0``): every microbatch traverses every stage, so a
        host's work is ``stage depth x n_micro`` — shifting a stage boundary
        (restage) is what changes its step time.
        """
        shares = self.plan.shares()
        depths = self.stage_plan.depths() if self.stage_plan is not None else {}
        if self.run_pipeline and self.stage_plan is not None:
            self._run_stage_pipeline()
        seconds: dict[int, float] = {}
        for host, share in shares.items():
            if self.stage_plan is not None:
                # the controller's map is authoritative (it prunes entries on
                # eviction); the fleet constructs it as host h -> stage h but
                # must not assume that identity here
                stage = self.controller.stage_for_host.get(host)
                work = depths.get(stage, 0) * self.plan.n_micro
            else:
                if self.run_pipeline:
                    self._run_host_pipeline(host, share)
                work = share
            seconds[host] = self.costs[host] * work
            self.transport.publish(host, seconds[host])
        self.last_step_seconds = seconds
        return seconds

    def _run_host_pipeline(self, host: int, share: int) -> None:
        """Really push the host's microbatch share through gpipe_forward on
        its local mesh (1 stage, tiny tensors) — correctness ballast for the
        simulated timing."""
        mesh = self.meshes[host]
        stage_w = torch.ones((1, self.feature_dim), device=self.device) * 0.5
        x = torch.ones((share * self.micro_batch, self.feature_dim), device=self.device)
        y = gpipe_forward(
            lambda w, a: a * w,
            stage_w,
            x,
            mesh=mesh,
            axis="pod",
            n_micro=share,
        )
        if y.shape != x.shape:
            raise AssertionError(f"pipeline shape drift: {y.shape} != {x.shape}")

    def _run_stage_pipeline(self) -> None:
        """Execute the current :class:`StagePlan` boundaries through a real
        1F1B step (packed params + slot mask on the local pod mesh) — proof
        that a restaged split still computes a loss and per-slot gradients."""
        plan = self.stage_plan
        assert plan is not None
        if self._layer_params is None:
            self._layer_params = (
                torch.ones((plan.n_layers, self.feature_dim), device=self.device) * 0.9
            )
            mesh = local_mesh((1,), ("pod",), self.device)
            self._pipeline_step = PipelineStep(
                lambda w, a: a * w,
                lambda y, t: ((y - t) ** 2).mean(),
                mesh=mesh,
                axis="pod",
                n_micro=self.plan.n_micro,
            )
        packed, mask = plan.pack(self._layer_params)
        batch = self.plan.n_micro * self.micro_batch
        x = torch.ones((batch, self.feature_dim), device=self.device)
        loss, grads = self._pipeline_step(packed, x, x * 0.5, stage_mask=mask)
        if not torch.isfinite(loss) or grads.shape != packed.shape:
            raise AssertionError(
                f"pipeline step broke: loss {float(loss)}, grad shape "
                f"{tuple(grads.shape)} != {tuple(packed.shape)}"
            )

    # -- queries -------------------------------------------------------------------
    def active_hosts(self) -> list[int]:
        return self.plan.hosts

    def spread(self) -> float:
        """Max - min step seconds across active hosts at the last step — the
        cross-host imbalance the control loop is trying to shrink."""
        vals = [
            s for h, s in self.last_step_seconds.items() if h in self.plan.weights
        ]
        if not vals:
            return 0.0
        return max(vals) - min(vals)

    # -- restage actuator ------------------------------------------------------------
    def _on_restage(self, host, stage, depths, report) -> None:
        """Record a stage-boundary move.  The next :meth:`run_step` (and the
        next :meth:`_run_stage_pipeline` pack) picks the new depths up from
        the shared plan — the simulated analogue of a launcher re-packing
        stage parameters before its next pipelined step."""
        self.restages.append((host, stage, dict(depths)))

    # -- eviction actuator -----------------------------------------------------------
    def _rebuild_meshes(self, host, report) -> None:
        """(Re)build every active host's local mesh — the simulated analogue
        of ``remove_host`` on a real fleet-spanning mesh.  Called at
        construction and again by the response controller on every eviction."""
        if host is not None:
            self.evicted.append(host)
            self.meshes.pop(host, None)
            self.costs.pop(host, None)
            self.nominal_costs.pop(host, None)
            self.last_step_seconds.pop(host, None)
            self.mesh_generation += 1
        self.meshes = {h: local_mesh((1,), ("pod",), self.device) for h in self.plan.hosts}
