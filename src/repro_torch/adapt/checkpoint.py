"""AdaptCheck as a control-plane citizen.

:class:`CheckpointControl` adapts the pure, replayable
:class:`~repro_torch.core.adaptive.AdaptiveCheckpointController` (paper Sec. 3.2)
onto the :class:`~repro_torch.adapt.controller.Controller` protocol: each poll it
reads the accumulated checkpoint walltime out of the timer database, applies
any live-steered policy parameters from the param registry (paper Sec. 5), and
asks the inner controller for a decision.  Admissions surface as
``checkpoint`` actions in the ``ADAPT/`` log; the launcher's CHECKPOINT-bin
routine consumes the pending decision with :meth:`take_decision` and performs
the actual write, then reports back through :meth:`observe_checkpoint` so the
duration predictor keeps learning.

This replaces the inline decision block ``launch.train`` used to carry:
the same policy now lives behind the same registry as every other adaptation.

With a durable-save routine bound (:meth:`CheckpointControl.bind_durable_save`)
the controller also serves as the fleet's **eviction barrier**: removing a host
rebuilds the mesh and re-apportions its work, so the last thing that should
happen *before* that irreversible step is a checkpoint that is known durable.
:meth:`evict_barrier` plugs into
:class:`~repro_torch.adapt.stragglers.StragglerResponse` — an eviction only proceeds
once the save lands, and the save itself shows up in the ``ADAPT/`` log as a
``checkpoint``-controller ``before_evict`` row.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable, Mapping

from ..core.adaptive import AdaptiveCheckpointController, AdaptiveCheckpointPolicy, Decision
from ..core.params import ParamRegistry
from .controller import ControlAction, Measurement

__all__ = ["CheckpointControl"]


class CheckpointControl:
    """Controller wrapping AdaptCheck; polls the checkpoint-write timer.

    Parameters
    ----------
    inner:
        The :class:`AdaptiveCheckpointController` holding policy + predictor
        (constructed by the caller so policies stay explicit and testable), or
        an :class:`AdaptiveCheckpointPolicy` to wrap in a fresh controller.
    ckpt_timer:
        Timer-DB channel accumulating checkpoint write walltime — the
        controller's trigger channel.
    clock:
        Monotonic time source (injectable for replay tests).
    registry / fraction_param / interval_param:
        When a registry is given, each poll re-reads the two steerable policy
        parameters and applies changes to the inner policy before deciding —
        live steering exactly as the training launcher did inline.
    """

    def __init__(
        self,
        inner: AdaptiveCheckpointController | AdaptiveCheckpointPolicy,
        *,
        ckpt_timer: str = "CHECKPOINT/adaptcheck::write",
        clock: Callable[[], float] = time.monotonic,
        registry: ParamRegistry | None = None,
        fraction_param: str = "ckpt.max_fraction",
        interval_param: str = "ckpt.max_interval_s",
    ) -> None:
        if isinstance(inner, AdaptiveCheckpointPolicy):
            inner = AdaptiveCheckpointController(inner)
        self.name = "adaptcheck"
        self.inner = inner
        self.ckpt_timer = ckpt_timer
        self.channels = (ckpt_timer,)
        self._clock = clock
        self._registry = registry
        self._fraction_param = fraction_param
        self._interval_param = interval_param
        self._pending: Decision | None = None
        #: durable-save routine for the eviction barrier; bound by the
        #: launcher (``bind_durable_save``) once a checkpoint manager exists
        self._durable_save: Callable[[int], float] | None = None
        #: seconds by which a write started at a step's poll would land
        #: before the run's final save (None where unknown); bound by the
        #: launcher (``bind_final_save``)
        self._final_save_margin: Callable[[int], float | None] | None = None
        #: barrier bookkeeping for summaries / tests
        self.barrier_saves = 0
        self.barrier_failures = 0

    # -- lifecycle ---------------------------------------------------------------
    def start_run(self, now: float | None = None) -> None:
        self.inner.start_run(self._clock() if now is None else now)

    def observe_checkpoint(self, seconds: float, nbytes: float = 0.0) -> None:
        """Report a completed write (feeds the predictor and the interval)."""
        self.inner.observe_checkpoint(self._clock(), seconds, nbytes)

    def take_decision(self) -> Decision | None:
        """Pop the decision made at the last poll (None when never polled)."""
        decision, self._pending = self._pending, None
        return decision

    def bind_final_save(self, margin: Callable[[int], float | None]) -> None:
        """Bind the launcher's estimate of the seconds by which an
        asynchronous write started at step ``step``'s poll would land before
        the run's final save: AdaptCheck starts none that would not
        (``AdaptiveCheckpointController.decide``)."""
        self._final_save_margin = margin

    # -- eviction barrier ---------------------------------------------------------
    def bind_durable_save(self, save_fn: Callable[[int], float]) -> None:
        """Bind the launcher's durable-save routine: ``save_fn(step)`` must
        write a checkpoint at ``step`` and *block until it is durable on
        disk* (manager ``save`` + ``wait``), returning the write seconds."""
        self._durable_save = save_fn

    def evict_barrier(self, step: int, report: object = None) -> ControlAction | None:
        """Checkpoint-before-evict: run a durable save, or veto the eviction.

        Plugged into :class:`~repro_torch.adapt.stragglers.StragglerResponse` as its
        ``evict_barrier``.  Returns the ``ADAPT/checkpoint::before_evict``
        action once a save is durably on disk — the eviction may proceed — or
        ``None`` (no save routine bound, or the save failed), which defers the
        eviction to a later check; the straggler streak keeps growing, so the
        eviction retries as soon as a save succeeds.
        """
        if self._durable_save is None:
            return None
        start = self._clock()
        try:
            seconds = float(self._durable_save(step))
        except Exception as exc:  # noqa: BLE001 - a failed save must veto, not crash
            self.barrier_failures += 1
            del exc
            return None
        if seconds <= 0.0:
            seconds = max(self._clock() - start, 0.0)
        self.barrier_saves += 1
        self.observe_checkpoint(seconds)
        return ControlAction(
            step=step,
            controller="checkpoint",
            trigger=self.ckpt_timer,
            action="before_evict",
            detail={"seconds": round(seconds, 6), "saves": self.barrier_saves},
        )

    # -- steering ---------------------------------------------------------------
    def _apply_steering(self) -> None:
        registry = self._registry
        if registry is None:
            return
        policy = self.inner.policy
        fraction = registry.get(self._fraction_param)
        interval = registry.get(self._interval_param)
        if (fraction, interval) != (policy.max_fraction, policy.max_interval_seconds):
            self.inner.policy = dataclasses.replace(
                policy, max_fraction=fraction, max_interval_seconds=interval
            )
            self.inner.policy.validate()

    # -- Controller protocol ------------------------------------------------------
    def control(
        self, step: int, measurements: Mapping[str, Measurement]
    ) -> list[ControlAction]:
        self._apply_steering()
        now = self._clock()
        # fraction is measured against *loop* wall time (from start_run), not
        # the STARTUP compile — matches the paper's "time spent on the problem"
        total = now - self.inner.started_at
        ckpt = measurements.get(self.ckpt_timer, Measurement(0.0, 0)).seconds
        margin = self._final_save_margin(step) if self._final_save_margin is not None else None
        decision = self.inner.decide(
            iteration=step, now=now, total_seconds=total, checkpoint_seconds=ckpt,
            final_save_margin=margin,
        )
        self._pending = decision
        if not decision.checkpoint:
            return []
        return [
            ControlAction(
                step=step,
                controller=self.name,
                trigger=self.ckpt_timer,
                action="checkpoint",
                detail={
                    "reason": decision.reason,
                    "fraction": round(decision.fraction, 6),
                    "predicted_s": round(decision.predicted_seconds, 6),
                },
            )
        ]

    def summary(self) -> dict:
        out = dict(self.inner.summary())
        if self.barrier_saves or self.barrier_failures:
            out["barrier"] = {
                "saves": self.barrier_saves,
                "failures": self.barrier_failures,
            }
        return out
