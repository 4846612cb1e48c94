"""Serving adaptation: batch-width steering + SLO load-shedding as a
:class:`~repro.adapt.controller.Controller`.

This is the serving half of the paper's thesis at production scale — the same
:class:`~repro.adapt.controller.ControlLoop` that rebalances training
microbatches polls this controller, so *every* runtime decision the system
takes (training or serving) lands in one decision log and one ``ADAPT/``
report section.  It replaces the private halve/double rule the old static
engine buried in ``_steer_batch_size``: decisions are now driven by the
``serve/decode`` timer channel (what the engine *measured*, not what it
guessed inline), applied through the steerable ``serving.max_active``
parameter and the engine's ``shed`` actuator, and recorded as
``ADAPT/serving::grow_batch`` / ``shrink_batch`` / ``shed`` rows.

Decision rules per poll (all gated on fresh measurements since the last
poll, with a post-action cooldown so a resize is judged on windows measured
*at* the new width):

* **shrink_batch** — decode-step latency above ``slo.target_decode_ms``:
  halve the admission width (floor 1).  Decode serves every in-flight
  request at once, so step latency is the per-token cadence every user sees.
* **grow_batch** — latency under ``slo.grow_headroom * target`` with
  requests waiting and width below the slot count: double the width.
* **shed** — the estimated tail queueing delay (queue depth over the
  measured completion rate, :func:`repro.serving.slo.shed_count`) exceeds
  ``slo.max_queue_delay_s``: drop exactly enough queued requests to meet the
  objective again.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

from ..core.params import ParamRegistry, param_registry
from ..serving.slo import ServiceLevel, shed_count
from .controller import ControlAction, Measurement

__all__ = ["ServingControl"]


class ServingControl:
    """Controller steering one :class:`~repro.serving.engine.ServeSession`.

    Parameters
    ----------
    engine:
        The serving engine to steer (exposes ``max_active``/``n_slots``,
        ``queue_depth``, ``completion_rate()`` and the ``shed`` actuator).
    slo:
        Objectives to enforce; defaults to the engine's own.  With neither
        ``target_decode_ms`` nor ``max_queue_delay_s`` set the controller
        observes but never acts.
    registry:
        Steerable-parameter registry holding ``serving.max_active`` (the
        process default when ``None`` — pass the engine's).
    cooldown:
        Polls to skip after a resize, so the next decision is based on
        windows measured entirely at the new width.
    """

    name = "serving"
    channels = ("serve/prefill", "serve/decode")

    def __init__(
        self,
        engine,
        slo: ServiceLevel | None = None,
        *,
        registry: ParamRegistry | None = None,
        cooldown: int = 2,
    ) -> None:
        self.engine = engine
        self.slo = slo if slo is not None else engine.slo
        self._registry = registry if registry is not None else param_registry()
        self.cooldown = cooldown
        self._cooldown_left = 0
        self._prev_decode = Measurement(0.0, 0)

    # -- measurement windows -----------------------------------------------------
    def _decode_step_ms(self, measurements: Mapping[str, Measurement]) -> float | None:
        """Mean decode-step latency over the windows since the last poll
        (``None`` when no decode ran in between — nothing to judge)."""
        decode = measurements["serve/decode"]
        d_sec = decode.seconds - self._prev_decode.seconds
        d_cnt = decode.count - self._prev_decode.count
        self._prev_decode = decode
        if d_cnt <= 0:
            return None
        return 1e3 * d_sec / d_cnt

    # -- dispatch ----------------------------------------------------------------
    def control(
        self, step: int, measurements: Mapping[str, Measurement]
    ) -> Iterable[ControlAction]:
        actions: list[ControlAction] = []
        step_ms = self._decode_step_ms(measurements)

        # shedding first: queue pressure is judged every poll, resize or not
        n_shed = shed_count(self.engine.queue_depth, self.engine.completion_rate(), self.slo)
        if n_shed:
            dropped = self.engine.shed(n_shed)
            actions.append(
                ControlAction(
                    step=step, controller=self.name, trigger="serve/queue_depth",
                    action="shed",
                    detail={
                        "n": len(dropped),
                        "rids": tuple(r.rid for r in dropped),
                        "queue_depth": self.engine.queue_depth,
                        "max_queue_delay_s": self.slo.max_queue_delay_s,
                    },
                )
            )

        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return actions
        if self.slo.target_decode_ms is None or step_ms is None:
            return actions

        width = self.engine.max_active
        if step_ms > self.slo.target_decode_ms and width > 1:
            new_width = max(width // 2, 1)
            self._resize(new_width)
            actions.append(self._resize_action(step, "shrink_batch", step_ms, width, new_width))
        elif (
            step_ms < self.slo.grow_headroom * self.slo.target_decode_ms
            and width < self.engine.n_slots
            and self.engine.queue_depth > 0
        ):
            new_width = min(width * 2, self.engine.n_slots)
            self._resize(new_width)
            actions.append(self._resize_action(step, "grow_batch", step_ms, width, new_width))
        return actions

    def _resize(self, new_width: int) -> None:
        self._registry.set("serving.max_active", new_width)
        self._cooldown_left = self.cooldown

    def _resize_action(
        self, step: int, verb: str, step_ms: float, width: int, new_width: int
    ) -> ControlAction:
        return ControlAction(
            step=step, controller=self.name, trigger="serve/decode", action=verb,
            detail={
                "decode_step_ms": step_ms,
                "target_ms": self.slo.target_decode_ms,
                "max_active": f"{width}->{new_width}",
            },
        )
