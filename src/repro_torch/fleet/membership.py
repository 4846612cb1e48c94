"""Elastic membership: the epoch-fenced host registry and its controller.

:class:`Membership` owns the authoritative *who-is-in-the-fleet* record: the
shared :class:`~repro_torch.dist.pipeline.MicrobatchPlan` (the same object the
straggler response mutates), each member's admission epoch, and the
monotonically increasing **membership epoch** that fences every transition.
Each change re-apportions microbatch shares in place (``MicrobatchPlan.
retarget`` — the N→M re-apportionment: survivors keep their learned weights,
newcomers enter at the carried mean), re-derives stage ownership
(:func:`~repro_torch.fleet.topology.stage_for_host`), and atomically publishes the
new record to the rendezvous store, where every worker reads its share and a
fenced-out rank discovers it is gone.

:class:`FleetController` is the :class:`~repro_torch.adapt.controller.Controller`
that drives transitions from the control loop, in this order each poll:

1. **leaves** — members whose heartbeat age exceeds the liveness timeout are
   evicted through the checkpoint-before-evict barrier (a ``None`` barrier
   verdict defers the leave to the next poll; the dead host stays fenced-out
   of gather either way once removed).  Rows: ``ADAPT/checkpoint::
   before_evict`` then ``ADAPT/fleet::leave``.
2. **joins** — pending join requests (``join/<host>`` keys written by
   workers) pass through the payback gate: an admission that does not pay for
   its re-shard within the horizon is skipped with an ``ADAPT/fleet::
   defer_reshard`` row and retried next poll; an admitted host earns share
   immediately (``ADAPT/fleet::join``).  A duplicate join of a present member
   is acknowledged idempotently — no second row, no epoch bump.
"""

from __future__ import annotations

import statistics
import time
from collections.abc import Callable
from typing import Any

from ..adapt.controller import ControlAction, Measurement
from ..adapt.stragglers import StragglerResponse
from ..dist.pipeline import MicrobatchPlan
from ..dist.stragglers import StragglerReport
from .payback import PaybackPolicy
from .store import FileStore
from .topology import stage_for_host
from .transport import FleetTransport

__all__ = ["FleetController", "Membership"]

#: the store key workers poll for their assignment + fence
MEMBERSHIP_KEY = "membership"


class Membership:
    """Controller-side membership state over the shared microbatch plan."""

    def __init__(
        self,
        store: FileStore,
        plan: MicrobatchPlan,
        *,
        n_stages: int = 0,
        liveness_timeout: float = 3.0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.store = store
        self.plan = plan
        self.n_stages = int(n_stages)
        self.liveness_timeout = float(liveness_timeout)
        self.clock = clock
        self.epoch = 1
        #: {host: epoch at which the host was admitted} — the gather fence
        self.joined_epoch: dict[int, int] = {h: 1 for h in plan.weights}
        self.publish()

    # -- views -------------------------------------------------------------------
    @property
    def hosts(self) -> list[int]:
        return sorted(self.plan.weights)

    def members_fn(self) -> tuple[int, dict[int, int]]:
        """The fence view :class:`~repro_torch.fleet.transport.FleetTransport`
        gathers against: (current epoch, {host: admission epoch})."""
        return self.epoch, dict(self.joined_epoch)

    def stage_map(self) -> dict[int, int]:
        return stage_for_host(self.hosts, self.n_stages)

    # -- transitions -------------------------------------------------------------
    def publish(self) -> None:
        """Atomically write the record every worker steers by."""
        shares = self.plan.shares() if self.plan.weights else {}
        stages = self.stage_map()
        self.store.put(
            MEMBERSHIP_KEY,
            {
                "epoch": self.epoch,
                "n_micro": self.plan.n_micro,
                "hosts": {
                    str(h): {
                        "weight": float(w),
                        "share": int(shares.get(h, 0)),
                        "stage": stages.get(h),
                        "joined_epoch": self.joined_epoch.get(h, self.epoch),
                    }
                    for h, w in self.plan.weights.items()
                },
                "updated": self.clock(),
            },
        )

    def admit(self, host: int) -> bool:
        """Grow the plan onto ``host`` (in place, so every holder of the plan
        sees the new apportionment), bump the epoch, publish.  Returns False
        for a duplicate admit of a present member — idempotent, no epoch
        bump, so a raced double join request cannot double-apportion."""
        host = int(host)
        if host in self.plan.weights:
            return False
        grown = self.plan.retarget([*self.plan.weights, host])
        self.plan.weights.clear()
        self.plan.weights.update(grown.weights)
        self.epoch += 1
        self.joined_epoch[host] = self.epoch
        self.publish()
        return True

    def remove(self, host: int) -> None:
        """Record a departure *after* the plan has already shed the host
        (``MicrobatchPlan.evict`` via the response policy): bump the epoch and
        publish, which fences the host out of every future gather."""
        host = int(host)
        self.joined_epoch.pop(host, None)
        self.plan.weights.pop(host, None)
        self.epoch += 1
        self.publish()
        self.store.delete(f"beat/{host}")
        self.store.delete(f"join/{host}")

    # -- liveness ----------------------------------------------------------------
    def beat_ages(self, now: float | None = None) -> dict[int, float]:
        """{host: seconds since last heartbeat} for current members (a member
        that never beat counts from its admission publish)."""
        now = self.clock() if now is None else now
        ages: dict[int, float] = {}
        for host in self.hosts:
            beat = self.store.get(f"beat/{host}")
            if beat is None:
                record = self.store.get(MEMBERSHIP_KEY) or {}
                ages[host] = now - float(record.get("updated", now))
            else:
                ages[host] = now - float(beat.get("t", 0.0))
        return ages

    def expired(self, now: float | None = None) -> list[int]:
        return sorted(
            h
            for h, age in self.beat_ages(now).items()
            if age > self.liveness_timeout
        )

    def pending_joins(self) -> list[dict[str, Any]]:
        return list(self.store.scan("join").values())


class FleetController:
    """The membership transitions as a control-plane citizen (name: ``fleet``).

    Wires together the membership registry, the straggler response (whose
    plan/detector must grow and shrink in lockstep), the transport (fencing),
    the payback gate, and the checkpoint-before-evict barrier.  Every
    transition and every skipped transition is returned as a
    :class:`ControlAction`, so the ``ADAPT/fleet::*`` rows are the complete
    journal of fleet shape over the run.
    """

    name = "fleet"

    def __init__(
        self,
        membership: Membership,
        transport: FleetTransport,
        response: StragglerResponse,
        *,
        payback: PaybackPolicy | None = None,
        evict_barrier: Callable[[int, StragglerReport | None], ControlAction | None]
        | None = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.membership = membership
        self.transport = transport
        self.response = response
        self.payback = payback
        self.evict_barrier = evict_barrier
        self.clock = clock
        self.channels: tuple[str, ...] = ()
        self.joins_total = 0
        self.leaves_total = 0
        self.deferred_leaves = 0

    # -- Controller protocol ------------------------------------------------------
    def control(
        self, step: int, measurements: dict[str, Measurement]
    ) -> list[ControlAction]:
        actions: list[ControlAction] = []
        actions.extend(self._process_leaves(step))
        actions.extend(self._process_joins(step))
        return actions

    # -- leaves ------------------------------------------------------------------
    def _process_leaves(self, step: int) -> list[ControlAction]:
        membership = self.membership
        actions: list[ControlAction] = []
        for host in membership.expired():
            if len(membership.hosts) <= 1:
                break  # never fence out the last live host
            if self.evict_barrier is not None:
                barrier = self.evict_barrier(step, None)
                if barrier is None:
                    # save not durable yet: the leave retries next poll; the
                    # host keeps missing beats, so nothing is forgotten
                    self.deferred_leaves += 1
                    continue
                actions.append(barrier)
            self.response.remove_host(host)
            membership.remove(host)
            self.leaves_total += 1
            actions.append(
                ControlAction(
                    step=step,
                    controller=self.name,
                    trigger=f"DIST/host{host}::step",
                    action="leave",
                    detail={
                        "host": host,
                        "reason": "heartbeat_expired",
                        "epoch": membership.epoch,
                        "survivors": membership.hosts,
                    },
                )
            )
        return actions

    # -- joins -------------------------------------------------------------------
    def _mean_step_seconds(self) -> float:
        means = self.response.detector.host_means()
        return statistics.mean(means.values()) if means else 0.0

    def _process_joins(self, step: int) -> list[ControlAction]:
        membership = self.membership
        actions: list[ControlAction] = []
        for request in membership.pending_joins():
            try:
                host = int(request["host"])
            except (KeyError, TypeError, ValueError):
                continue
            if host in membership.plan.weights:
                # duplicate join of a present member: ack idempotently
                membership.store.delete(f"join/{host}")
                continue
            if self.payback is not None:
                gate = self.payback.join_gate(
                    step, host, len(membership.hosts), self._mean_step_seconds()
                )
                if gate is not None:
                    actions.append(gate)  # request stays pending; retried
                    continue
            membership.admit(host)
            self.response.register_host(host)
            membership.store.delete(f"join/{host}")
            self.joins_total += 1
            actions.append(
                ControlAction(
                    step=step,
                    controller=self.name,
                    trigger=f"join/{host}",
                    action="join",
                    detail={
                        "host": host,
                        "epoch": membership.epoch,
                        "weight": round(membership.plan.weights[host], 4),
                        "shares": membership.plan.shares(),
                    },
                )
            )
        return actions

    # -- external views -----------------------------------------------------------
    def status_payload(self) -> dict[str, Any]:
        """The ``/fleet`` endpoint + exporter payload."""
        membership = self.membership
        shares = membership.plan.shares() if membership.plan.weights else {}
        ages = membership.beat_ages()
        stages = membership.stage_map()
        return {
            "epoch": membership.epoch,
            "hosts": {
                str(h): {
                    "weight": float(membership.plan.weights[h]),
                    "share": int(shares.get(h, 0)),
                    "stage": stages.get(h),
                    "beat_age_s": round(ages.get(h, 0.0), 3),
                    "joined_epoch": membership.joined_epoch.get(h),
                }
                for h in membership.hosts
            },
            "joins_total": self.joins_total,
            "leaves_total": self.leaves_total,
            "reshard_defers_total": (
                sum(self.payback.defers.values()) if self.payback is not None else 0
            ),
            "deferred_leaves": self.deferred_leaves,
            "stale_samples_rejected": self.transport.stale_rejected,
            "liveness_timeout_s": membership.liveness_timeout,
        }
