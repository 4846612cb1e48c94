"""Straggler response: rebalance microbatch shares, then evict — the paper's
"dynamically adapt itself to a changing environment" loop closed at fleet
scale (cf. the Cactus Worm migration experiments, Allen et al. cs/0108001:
measure, decide, migrate).

:class:`StragglerResponse` sits between the measurement reduction
(:class:`~repro_torch.dist.stragglers.StragglerDetector`, fed by all hosts through
an injectable transport) and three actuators:

* **restage** — when the confirmed straggler *owns a pipeline stage* (the
  controller was given a :class:`~repro_torch.dist.pipeline.StagePlan` and a
  ``host -> stage`` map), move the stage boundaries: derate the stage's
  capacity weight by the same equilibrium rule so the largest-remainder depth
  apportionment sheds whole layers off the slow device.  A stage owner's work
  is depth-bound (every microbatch traverses its stage), so the microbatch
  share derate would move no work for it: when the boundary cannot shift any
  further, escalation goes straight to the eviction streak backstop;
* **rebalance** — set the flagged host's weight in the fleet's
  :class:`~repro_torch.dist.pipeline.MicrobatchPlan` to its equilibrium (nominal
  weight / per-microbatch slowdown, floored at ``min_weight``), so its share
  of the pipelined microbatches matches its degraded capacity.  Slowdown is
  *share-normalized*: a host deliberately provisioned with a larger weight is
  not "slow" merely for taking proportionally longer steps;
* **restore** — the inverse: a derated host whose per-unit time is back in
  line (the slowdown was transient — a noisy neighbor, thermal throttling
  that cleared) earns its weight back by the same equilibrium rule, capped at
  its *original* weight, so a one-off hiccup never permanently costs the
  fleet capacity;
* **evict** — when a host stays flagged at the minimum weight (it is too slow
  to be worth its guaranteed share) or keeps getting flagged past the streak
  backstop, remove it: from the plan, from the detector's median, and from
  the transport, then hand the host to ``on_evict`` so the launcher rebuilds
  its mesh.

After every weight change the host's detector window and streak are reset:
samples measured under the old assignment no longer describe the host, and
judging the new assignment on stale samples compounds derates into spurious
evictions of already-fixed hosts.

Every decision is returned as a :class:`ControlAction` so the control loop
records it in the ``ADAPT/`` log with the triggering ``DIST/host{h}::step``
channel.
"""

from __future__ import annotations

import statistics
from collections.abc import Callable, Mapping

from ..dist.pipeline import MicrobatchPlan, StagePlan
from ..dist.stragglers import StragglerDetector, StragglerReport
from .controller import ControlAction, Measurement

__all__ = ["StragglerResponse"]

#: shared stepped-probe policy for both granularity probes (microbatch share
#: in :meth:`StragglerResponse._weight_dropping_share`, stage depth in
#: :meth:`StragglerResponse._try_restage`): weights decay by this factor per
#: probe until the ``min_weight`` floor (within the epsilon guard) — tune it
#: here so the two actuators keep identical exhaustion semantics
_PROBE_DECAY = 0.75
_PROBE_FLOOR_EPS = 1e-12


class StragglerResponse:
    """Rebalance-then-evict policy over a straggler detector and a plan.

    Parameters
    ----------
    detector:
        The cross-host reduction point.  The controller drains its transport
        and runs :meth:`~repro_torch.dist.stragglers.StragglerDetector.check` every
        ``check_every`` polls.
    plan:
        The fleet's microbatch assignment to act on.
    check_every:
        Polls between fleet checks (mirrors a launcher checking every N
        steps; the check fires on polls where ``(step + 1) % check_every == 0``).
    confirm_after:
        Consecutive flagged checks before the first rebalance — one flagged
        window can be a transient (GC pause, kernel hiccup); a confirmed
        straggler is one that stays slow.
    evict_after:
        Consecutive flagged checks after which the host is evicted regardless
        of weight.  The streak resets on every weight change, whenever the
        flag turns out share-induced (per-unit time fine), and whenever the
        raw flag clears — so escalation only counts checks where the host was
        genuinely slow and no rebalance could absorb it (already at the
        weight floor, or share granularity exhausted).
    min_weight:
        Floor for a rebalanced host's weight.  A host flagged *at* the floor
        has already been derated as far as policy allows and is evicted.
    rel_tol:
        Minimum relative weight change worth acting on (hysteresis guard
        against churning the plan for measurement noise).
    local_feed:
        Optional ``(host, timer_name)``: each poll additionally samples this
        process's own step timer straight out of the timer database — the
        single-process path the training launcher uses alongside (or instead
        of) a transport.
    stage_plan / stage_for_host:
        Optional pipeline-stage wiring: ``stage_plan`` is the fleet's
        :class:`~repro_torch.dist.pipeline.StagePlan` and ``stage_for_host`` maps a
        host id to the pipeline stage it owns.  A confirmed straggler that
        owns a stage is answered with a **restage** (stage weight derated by
        the equilibrium rule until the depth apportionment actually sheds a
        layer off *its* stage); when the boundary cannot move further (stage
        already at one layer, or weight floor reached without a depth change)
        the policy escalates straight to the ``evict_after`` backstop — a
        stage owner runs every microbatch through its stage, so the
        microbatch share derate would shed no work for it.  Per-unit slowdown
        for stage owners is normalized by ``n_micro x stage depth``
        (share-independent) — a deliberately deeper stage is not "slow" for
        taking proportionally longer.
    on_rebalance / on_evict / on_restage:
        Actuator callbacks: ``on_rebalance(host, weight, report)`` after a
        weight change, ``on_evict(host, report)`` after an eviction (where the
        launcher rebuilds the mesh), ``on_restage(host, stage, depths,
        report)`` after a stage-boundary move (where the launcher re-packs
        stage parameters).
    evict_barrier:
        Optional checkpoint-before-evict gate: ``evict_barrier(step, report)``
        must make the fleet safe to shrink (durably checkpoint) and return the
        :class:`ControlAction` describing what it did — recorded *before* the
        ``evict`` row — or ``None`` to veto.  On a veto the eviction is
        deferred, not cancelled: the streak is left growing, so the next
        flagged check retries the barrier.  Typically
        :meth:`repro_torch.adapt.checkpoint.CheckpointControl.evict_barrier`.
    reshard_gate:
        Optional payback gate, consulted *before* the barrier:
        ``reshard_gate(step, host, report, slowdown)`` returns ``None`` when
        the projected win of shedding the host covers the re-shard cost (the
        eviction proceeds), or a :class:`ControlAction` (an
        ``ADAPT/fleet::defer_reshard`` row) recording why the move is not
        worth it — the eviction is skipped, the action is recorded, and the
        streak keeps growing so the gate re-evaluates every flagged check.
        Typically the fleet's payback policy (its ``evict_gate``).
    """

    def __init__(
        self,
        detector: StragglerDetector,
        plan: MicrobatchPlan,
        *,
        check_every: int = 1,
        confirm_after: int = 1,
        evict_after: int = 4,
        min_weight: float = 0.25,
        rel_tol: float = 0.05,
        local_feed: tuple[int, str] | None = None,
        stage_plan: StagePlan | None = None,
        stage_for_host: Mapping[int, int] | None = None,
        on_rebalance: Callable[[int, float, StragglerReport], None] | None = None,
        on_evict: Callable[[int, StragglerReport], None] | None = None,
        on_restage: Callable[[int, int, dict[int, int], StragglerReport], None] | None = None,
        evict_barrier: Callable[[int, StragglerReport], ControlAction | None] | None = None,
        reshard_gate: Callable[[int, int, StragglerReport, float], ControlAction | None]
        | None = None,
    ) -> None:
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if confirm_after < 1:
            raise ValueError(f"confirm_after must be >= 1, got {confirm_after}")
        if evict_after < confirm_after:
            raise ValueError(
                f"evict_after ({evict_after}) must be >= confirm_after ({confirm_after})"
            )
        if not 0.0 < min_weight <= 1.0:
            raise ValueError(f"min_weight must be in (0, 1], got {min_weight}")
        self.name = "stragglers"
        self.detector = detector
        self.plan = plan
        self.check_every = check_every
        self.confirm_after = confirm_after
        self.evict_after = evict_after
        self.min_weight = min_weight
        self.rel_tol = rel_tol
        if (stage_plan is None) != (stage_for_host is None):
            raise ValueError(
                "stage_plan and stage_for_host must be passed together"
            )
        self.local_feed = local_feed
        self.stage_plan = stage_plan
        self.stage_for_host = dict(stage_for_host) if stage_for_host else {}
        self.on_rebalance = on_rebalance
        self.on_evict = on_evict
        self.on_restage = on_restage
        self.evict_barrier = evict_barrier
        self.reshard_gate = reshard_gate
        #: evictions vetoed by the barrier (save not yet durable) — each one
        #: is a deferral, retried on the next flagged check
        self.deferred_evictions = 0
        #: evictions skipped by the payback gate (projected win under the
        #: re-shard cost) — each skip is its own recorded defer_reshard row
        self.deferred_reshards = 0
        self.channels = tuple(
            f"DIST/host{h}::step" for h in range(detector.n_hosts)
        )
        self._streak: dict[int, int] = {}
        #: each host's weight at registration — the ceiling restores climb
        #: back to (plans may assign above-1.0 weights to bigger hosts)
        self._full_weight: dict[int, float] = dict(plan.weights)
        #: each stage's weight at registration — the restage derate baseline
        self._full_stage_weight: dict[int, float] = (
            dict(stage_plan.weights) if stage_plan is not None else {}
        )

    # -- Controller protocol ------------------------------------------------------
    def control(
        self, step: int, measurements: Mapping[str, Measurement]
    ) -> list[ControlAction]:
        detector = self.detector
        if self.local_feed is not None:
            host, timer_name = self.local_feed
            detector.observe_timer(host, timer_name)
        detector.drain_transport()
        if (step + 1) % self.check_every != 0:
            return []
        report = detector.check(step)
        flagged = set(report.stragglers)
        for host in list(self._streak):
            if host not in flagged:
                self._streak[host] = 0
        # snapshot the work units the report's means were measured under:
        # acting on the first of two simultaneous stragglers changes every
        # host's live share (or stage depth), and dividing the second host's
        # (old-assignment) mean by its new units would misjudge it as
        # assignment-induced
        shares = self._work_units(self.plan.shares())
        actions: list[ControlAction] = []
        for host in sorted(flagged):
            self._streak[host] = self._streak.get(host, 0) + 1
            actions.extend(self._respond(step, host, report, shares))
        for host in self.plan.hosts:
            if host not in flagged:
                if self._owns_stage(host):
                    action = self._restore_stage(step, host, report, shares)
                else:
                    action = self._restore(step, host, report, shares)
                if action is not None:
                    actions.append(action)
        return actions

    # -- elastic membership --------------------------------------------------------
    def register_host(self, host: int, stage: int | None = None) -> None:
        """Adopt a newly admitted host (elastic membership join).

        The membership layer grows the shared plan first (``MicrobatchPlan.
        retarget`` in place — the newcomer enters at the carried mean weight);
        this call brings the response's own state into lockstep: the weight
        ceiling registers, the detector grows a window, the trigger-channel
        surface extends, and (optionally) the host takes a pipeline stage.
        """
        host = int(host)
        if host not in self.plan.weights:
            raise ValueError(f"host {host} not in the plan; grow the plan first")
        self._full_weight[host] = self.plan.weights[host]
        self.detector.add_host(host)
        self._streak[host] = 0
        self.channels = tuple(
            sorted(set(self.channels) | {f"DIST/host{host}::step"})
        )
        if stage is not None and self.stage_plan is not None:
            self.stage_for_host[host] = int(stage)

    def remove_host(self, host: int) -> None:
        """Shed a departing host without judging it (heartbeat-expiry leaves,
        operator drains): the same plan/detector/transport/stage bookkeeping
        as a straggler eviction, minus the ``evict`` action row and the
        ``on_evict`` callback — the caller owns the departure's journal."""
        host = int(host)
        self.plan.evict(host)
        self.detector.evict(host)
        self._streak.pop(host, None)
        self._full_weight.pop(host, None)
        self._drop_orphan_stage(host)

    def _drop_orphan_stage(self, host: int) -> None:
        """An evicted host's stage must not stay in the StagePlan: depths()
        would keep apportioning layers to a rank nobody runs.  Drop the stage
        (its layers re-apportion among survivors) unless another host still
        owns it."""
        stage = self.stage_for_host.pop(host, None)
        if (
            self.stage_plan is not None
            and stage is not None
            and stage in self.stage_plan.weights
            and stage not in self.stage_for_host.values()
            and len(self.stage_plan.weights) > 1
        ):
            del self.stage_plan.weights[stage]
            self._full_stage_weight.pop(stage, None)

    # -- policy -------------------------------------------------------------------
    def _owns_stage(self, host: int) -> bool:
        return (
            self.stage_plan is not None
            and self.stage_for_host.get(host) in self.stage_plan.weights
        )

    def _work_units(self, shares: Mapping[int, float]) -> dict[int, float]:
        """{host: work units per step}.

        For a data-parallel host this is its microbatch share.  A host that
        owns a pipeline stage runs *every* microbatch through its stage
        regardless of share, so its work is ``n_micro x stage depth`` —
        share-independent.  Normalizing a stage owner by its share would make
        a share derate (which moves no work for it) look like a slowdown and
        a small-share healthy host look like a straggler.
        """
        depths = self.stage_plan.depths() if self.stage_plan is not None else {}
        units: dict[int, float] = {}
        for h, s in shares.items():
            stage = self.stage_for_host.get(h)
            if stage in depths:
                units[h] = self.plan.n_micro * depths[stage]
            else:
                units[h] = s
        return units

    def _unit_slowdown(
        self, host: int, report: StragglerReport, shares: Mapping[int, float]
    ) -> float | None:
        """Per-work-unit slowdown vs the fleet's median per-unit time.

        The detector flags on *raw* step time — the right fleet-health signal,
        but it conflates "slow per unit of work" with "deliberately assigned
        more work" (a weight-2 host takes proportionally longer steps by
        design).  The response policy therefore normalizes by each host's
        work units (microbatch share x owned stage depth) before deciding, so
        only genuine per-unit slowness is ever acted on.  ``shares`` is the
        caller's per-check snapshot — the apportionment the report's means
        were measured under.
        """
        per_unit = {
            h: mean / shares[h]
            for h, mean in report.host_means.items()
            if shares.get(h)
        }
        if host not in per_unit:
            return None
        med = statistics.median(per_unit.values())
        if med <= 0.0:
            return None
        return per_unit[host] / med

    def _target_weight(self, host: int, slowdown: float) -> float:
        """Equilibrium weight: nominal capacity derated by per-unit slowdown."""
        full = self._full_weight.get(host, 1.0)
        return min(max(full / slowdown, self.min_weight), full)

    def _weight_dropping_share(self, host: int) -> float | None:
        """Largest probed weight >= ``min_weight`` that sheds one microbatch.

        The weight->share mapping is stepped (largest-remainder with a
        reserved minimum), so a host can sit at its equilibrium *weight*
        while rounding parks one extra microbatch on it.  Probing the actual
        apportionment separates that case (shed the microbatch) from true
        granularity exhaustion (``None``: nothing below ``min_weight`` moves
        the share — escalation is all that is left).  The plan is restored
        before returning; the loop is synchronous, so the in-place probe is
        not observable.
        """
        plan = self.plan
        current = plan.shares()[host]
        if current <= 1:
            return None
        saved = plan.weights[host]
        found = None
        probe = saved
        try:
            while probe > self.min_weight + _PROBE_FLOOR_EPS:
                probe = max(probe * _PROBE_DECAY, self.min_weight)
                plan.weights[host] = probe
                if plan.shares()[host] < current:
                    found = probe
                    break
        finally:
            plan.weights[host] = saved
        return found

    def _respond(
        self, step: int, host: int, report: StragglerReport, shares: Mapping[int, float]
    ) -> list[ControlAction]:
        plan = self.plan
        streak = self._streak[host]
        if streak < self.confirm_after:
            return []  # not yet confirmed: wait out transients
        weight = plan.weights.get(host)
        if weight is None:  # host not in this plan (already gone)
            return []
        slowdown = self._unit_slowdown(host, report, shares)
        if slowdown is None or slowdown <= self.detector.threshold:
            # the raw-step-time flag was share-induced, not per-unit slowness
            self._streak[host] = 0
            return []
        if self._owns_stage(host):
            # a stage owner's work is depth-bound: move its boundary; when
            # the boundary cannot move further, a share derate would shed no
            # work, so escalation goes straight to the eviction backstop
            restaged = self._try_restage(step, host, report, slowdown)
            if restaged is not None:
                return [restaged]
            if streak >= self.evict_after and len(plan.weights) > 1:
                return self._evict_with_barrier(step, host, report, slowdown)
            return []
        at_floor = weight <= self.min_weight * (1.0 + 1e-9)
        if (at_floor or streak >= self.evict_after) and len(plan.weights) > 1:
            return self._evict_with_barrier(step, host, report, slowdown)
        desired = self._target_weight(host, slowdown)
        if desired >= weight * (1.0 - self.rel_tol):
            # Weight already matches the degraded capacity, yet the host is
            # still raw-flagged.  Two distinct causes:
            #  - apportionment rounding parked one extra microbatch on the
            #    derated host -> shed it (a weight that actually drops the
            #    share exists);
            #  - share granularity is exhausted (already at the 1-microbatch
            #    minimum / weight floor) -> leave the streak growing, which
            #    is exactly the case the evict_after backstop exists for.
            shed = self._weight_dropping_share(host)
            if shed is None:
                return []
            desired = shed
        self._set_weight(host, desired, report)
        return [
            ControlAction(
                step=step,
                controller=self.name,
                trigger=f"DIST/host{host}::step",
                action="rebalance",
                detail={
                    "host": host,
                    "slowdown": round(slowdown, 3),
                    "weight": round(desired, 4),
                    "shares": plan.shares(),
                },
            )
        ]

    def _evict_with_barrier(
        self, step: int, host: int, report: StragglerReport, slowdown: float
    ) -> list[ControlAction]:
        """Run the checkpoint-before-evict barrier, then evict.

        Eviction is irreversible (the mesh rebuilds without the host), so the
        barrier's durable save must land *first*.  A ``None`` from the barrier
        vetoes this check's eviction — the streak is deliberately left intact,
        so the next flagged check retries; a wedged checkpoint path therefore
        delays shrinking the fleet instead of shrinking it unsafely.

        The payback gate runs even earlier: when the projected win of
        shedding the host does not cover the re-shard cost, the returned
        ``defer_reshard`` action is recorded *instead of* evicting (and
        instead of paying for a barrier save the fleet then would not use).
        The streak stays, so the gate re-evaluates on every flagged check —
        a host that keeps degrading eventually pays back and goes."""
        if self.reshard_gate is not None:
            deferred = self.reshard_gate(step, host, report, slowdown)
            if deferred is not None:
                self.deferred_reshards += 1
                return [deferred]
        if self.evict_barrier is not None:
            barrier_action = self.evict_barrier(step, report)
            if barrier_action is None:
                self.deferred_evictions += 1
                return []
            return [barrier_action, self._evict(step, host, report, slowdown)]
        return [self._evict(step, host, report, slowdown)]

    def _try_restage(
        self, step: int, host: int, report: StragglerReport, slowdown: float
    ) -> ControlAction | None:
        """Move the stage boundary off a slow stage owner, if it can move.

        Derates the owned stage's capacity weight to its equilibrium (nominal
        stage weight / per-unit slowdown, floored at ``min_weight``) and, when
        the equilibrium weight alone does not change the largest-remainder
        depth apportionment, probes smaller weights until one actually sheds
        a layer — mirroring :meth:`_weight_dropping_share` on the microbatch
        side.  Returns ``None`` when the host owns no stage, the stage is
        already at one layer, or no admissible weight moves the boundary —
        granularity exhausted: the caller escalates straight to the
        ``evict_after`` backstop (a share derate would shed no work for a
        depth-bound stage owner).
        """
        plan = self.stage_plan
        if plan is None:
            return None
        stage = self.stage_for_host.get(host)
        if stage is None or stage not in plan.weights:
            return None
        depths = plan.depths()
        if depths[stage] <= 1:
            return None  # boundary cannot move further
        full = self._full_stage_weight.get(stage, 1.0)
        saved = plan.weights[stage]
        candidate = min(max(full / slowdown, self.min_weight), saved)
        plan.weights[stage] = candidate
        # success means the straggler's OWN stage sheds a layer — rounding can
        # move a layer between two healthy stages while the slow one keeps its
        # full depth, and counting that as a restage would churn boundaries
        # and reset the escalation streak without making the host any faster
        shed = plan.depths()[stage] < depths[stage]
        while not shed and candidate > self.min_weight + _PROBE_FLOOR_EPS:
            # stepped apportionment: probe down for a weight that sheds a layer
            candidate = max(candidate * _PROBE_DECAY, self.min_weight)
            plan.weights[stage] = candidate
            shed = plan.depths()[stage] < depths[stage]
        if not shed:
            plan.weights[stage] = saved
            return None
        new_depths = plan.depths()
        # same stale-sample hygiene as a share change: the host's next
        # judgment must use samples measured under the new stage depth
        self.detector.reset_window(host)
        self._streak[host] = 0
        if self.on_restage is not None:
            self.on_restage(host, stage, new_depths, report)
        return ControlAction(
            step=step,
            controller=self.name,
            trigger=f"DIST/host{host}::step",
            action="restage",
            detail={
                "host": host,
                "stage": stage,
                "slowdown": round(slowdown, 3),
                "weight": round(candidate, 4),
                "depths": new_depths,
            },
        )

    def _restore_stage(
        self, step: int, host: int, report: StragglerReport, shares: Mapping[int, float]
    ) -> ControlAction | None:
        """Give a restaged, now-healthy stage owner its layers back.

        The stage-side mirror of :meth:`_restore`: the stage weight climbs
        toward its registered full value by the same equilibrium rule
        (``full / per-unit slowdown``, capped at full), so a transient
        throttle never permanently parks layers on the healthy stages.  An
        action is only emitted when the climb actually moves a boundary; a
        sub-granularity weight climb is applied silently (the next checks
        keep climbing until a layer moves back or the ceiling is reached).
        Per-unit slowdown is depth-normalized, so a host that just regained a
        layer is not re-judged slow merely for running more layers.
        """
        plan = self.stage_plan
        stage = self.stage_for_host.get(host)
        if plan is None or stage not in plan.weights or not shares.get(host):
            return None
        weight = plan.weights[stage]
        full = self._full_stage_weight.get(stage, 1.0)
        if weight >= full:
            return None
        slowdown = self._unit_slowdown(host, report, shares)
        if slowdown is None or slowdown <= 0.0:
            return None
        desired = min(max(full / slowdown, self.min_weight), full)
        if desired <= weight * (1.0 + self.rel_tol):
            return None  # not measurably under-loaded: leave it
        depths_before = plan.depths()
        plan.weights[stage] = desired
        new_depths = plan.depths()
        if new_depths == depths_before:
            return None  # weight climbed, boundary unchanged: no action yet
        self.detector.reset_window(host)
        self._streak[host] = 0
        if self.on_restage is not None:
            self.on_restage(host, stage, new_depths, report)
        return ControlAction(
            step=step,
            controller=self.name,
            trigger=f"DIST/host{host}::step",
            action="restore",
            detail={
                "host": host,
                "stage": stage,
                "slowdown": round(slowdown, 3),
                "weight": round(desired, 4),
                "depths": new_depths,
            },
        )

    def _restore(
        self, step: int, host: int, report: StragglerReport, shares: Mapping[int, float]
    ) -> ControlAction | None:
        """Give a derated, now-healthy host its weight back (same equilibrium
        rule as rebalance, capped at the host's original weight)."""
        weight = self.plan.weights.get(host)
        if weight is None or not shares.get(host):
            return None
        full = self._full_weight.get(host, 1.0)
        if weight >= full:
            return None
        slowdown = self._unit_slowdown(host, report, shares)
        if slowdown is None or slowdown <= 0.0:
            return None
        desired = self._target_weight(host, slowdown)
        if desired <= weight * (1.0 + self.rel_tol):
            return None  # not measurably under-loaded: leave it
        # Anti-oscillation: a still-unit-slow host sitting one granularity
        # step below a share that re-flags it must not ping-pong
        # shed -> restore every check — predict the step time at the restored
        # share and stay put if it would immediately re-flag.  Hosts whose
        # per-unit time is healthy are exempt: their raw flags are
        # share-induced (deliberately heavy hosts) and filtered in _respond.
        if slowdown > self.detector.threshold:
            saved = self.plan.weights[host]
            self.plan.weights[host] = desired
            try:
                new_units = self.plan.shares()[host]
            finally:
                self.plan.weights[host] = saved
            unit_seconds = report.host_means[host] / shares[host]
            predicted = unit_seconds * new_units
            fleet_median = statistics.median(report.host_means.values())
            if fleet_median > 0.0 and predicted > self.detector.threshold * fleet_median:
                return None
        self._set_weight(host, desired, report)
        return ControlAction(
            step=step,
            controller=self.name,
            trigger=f"DIST/host{host}::step",
            action="restore",
            detail={
                "host": host,
                "slowdown": round(slowdown, 3),
                "weight": round(desired, 4),
                "shares": self.plan.shares(),
            },
        )

    def _set_weight(self, host: int, weight: float, report: StragglerReport) -> None:
        """Apply a weight change; stale-sample hygiene lives here.  The
        detector window and the streak are reset so the host's *next*
        judgment uses only samples measured under the new assignment."""
        self.plan.set_weight(host, weight)
        self.detector.reset_window(host)
        self._streak[host] = 0
        if self.on_rebalance is not None:
            self.on_rebalance(host, weight, report)

    def _evict(
        self, step: int, host: int, report: StragglerReport, slowdown: float
    ) -> ControlAction:
        self.remove_host(host)
        if self.on_evict is not None:
            self.on_evict(host, report)
        return ControlAction(
            step=step,
            controller=self.name,
            trigger=f"DIST/host{host}::step",
            action="evict",
            detail={
                "host": host,
                "slowdown": round(slowdown, 3),
                "survivors": self.plan.hosts,
                "shares": self.plan.shares(),
            },
        )
