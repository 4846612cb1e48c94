"""Latency service-level objectives and the admission/shedding arithmetic.

:class:`ServiceLevel` is the declarative half — the operator states what
"acceptable" means (decode-step latency target, maximum tolerable queueing
delay); the pure functions below turn measurements into decisions.  The
*decision-taking* lives on the adapt control plane
(:class:`repro.adapt.serving.ServingControl` reads the ``serve/decode`` timer
channel and the queue, calls these helpers, and records every resulting
action as an ``ADAPT/serving::*`` row) — this module deliberately holds no
state and touches no engine, so the policy is unit-testable arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ServiceLevel", "estimated_queue_delay", "shed_count"]


@dataclass(frozen=True)
class ServiceLevel:
    """What the operator promised users, as numbers.

    Parameters
    ----------
    target_decode_ms:
        Latency target for one decode step of the persistent batch (the
        cadence at which every in-flight request receives its next token).
        ``None`` disables batch-size steering.
    max_queue_delay_s:
        Largest acceptable *estimated* wait in the admission queue; pending
        requests beyond it are shed rather than served late.  ``None``
        disables shedding.
    grow_headroom:
        Fraction of ``target_decode_ms`` under which the batch is considered
        comfortable and admission may widen (grow is attempted below
        ``grow_headroom * target``, shrink above ``target``).
    shed_from:
        Which end of the queue sheds first: ``"newest"`` preserves
        first-come-first-served fairness for the requests already waiting;
        ``"oldest"`` bounds worst-case staleness instead.
    """

    target_decode_ms: float | None = None
    max_queue_delay_s: float | None = None
    grow_headroom: float = 0.5
    shed_from: str = "newest"

    def __post_init__(self) -> None:
        if self.target_decode_ms is not None and self.target_decode_ms <= 0:
            raise ValueError("target_decode_ms must be positive")
        if self.max_queue_delay_s is not None and self.max_queue_delay_s <= 0:
            raise ValueError("max_queue_delay_s must be positive")
        if not 0.0 < self.grow_headroom <= 1.0:
            raise ValueError("grow_headroom must be in (0, 1]")
        if self.shed_from not in ("oldest", "newest"):
            raise ValueError("shed_from must be 'oldest' or 'newest'")


def estimated_queue_delay(queue_depth: int, completion_rate: float) -> float | None:
    """Expected wait of the *last* queued request, in seconds.

    ``completion_rate`` is the engine's recent requests-per-second; with an
    open admission loop the queue drains at that rate, so the tail request
    waits ``depth / rate``.  Returns ``None`` (no estimate, never shed on it)
    until the engine has completed enough work to measure a rate.
    """
    if queue_depth <= 0:
        return 0.0
    if completion_rate <= 0.0:
        return None
    return queue_depth / completion_rate


def shed_count(queue_depth: int, completion_rate: float, slo: ServiceLevel) -> int:
    """How many queued requests to shed so the estimated tail wait meets the
    SLO.  Zero when shedding is disabled, the estimate is unavailable, or the
    queue already meets the objective."""
    if slo.max_queue_delay_s is None or queue_depth <= 0:
        return 0
    delay = estimated_queue_delay(queue_depth, completion_rate)
    if delay is None or delay <= slo.max_queue_delay_s:
        return 0
    keep = int(slo.max_queue_delay_s * completion_rate)
    return max(queue_depth - keep, 0)
