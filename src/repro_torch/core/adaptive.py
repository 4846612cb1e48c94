"""AdaptCheck — adaptive checkpoint control from real-time profiling (paper Sec. 3.2).

The controller consumes the timing infrastructure's measurements (total wall time
and accumulated checkpoint time, read from the timer database) and decides, each
iteration, whether a checkpoint should be written now.  Guarantees, matching the
paper:

* **Weak fraction bound** — no checkpoint is *started* while the fraction of wall
  time already spent checkpointing exceeds ``max_fraction``.  (Weak: a checkpoint
  that pushes the fraction above the bound afterwards is allowed.)
* **Max-interval guarantee** — if more than ``max_interval_seconds`` of wall time
  have passed since the last checkpoint, a checkpoint is forced regardless of the
  fraction bound (fault-tolerance floor).  This overrides the fraction bound, as
  in the paper.

Beyond-paper (the paper's stated future work, implemented here):

* **Duration predictor** — a least-squares ``duration ≈ a + b·bytes`` model over
  the observed checkpoint history (falling back to an EMA when bytes do not
  vary).  With the predictor on, the controller checkpoints *as early as the
  bound allows* — i.e. when ``(ckpt + t̂)/(total + t̂) ≤ max_fraction`` — which
  keeps the realised fraction close to the bound from below instead of
  oscillating around it.
* **Queue-deadline final checkpoint** — given ``queue_ends_at`` (seconds of
  wall time available to the job), the controller forces a final checkpoint when
  the predicted write time (+ safety margin) would no longer fit before the
  queue expires, making the final checkpoint reliable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "CheckpointDurationPredictor",
    "AdaptiveCheckpointPolicy",
    "AdaptiveCheckpointController",
    "Decision",
]


class CheckpointDurationPredictor:
    """Predicts the next checkpoint's duration from (bytes, duration) history."""

    def __init__(self, window: int = 16, default_seconds: float = 1.0) -> None:
        self.window = int(window)
        self.default_seconds = float(default_seconds)
        self._history: list[tuple[float, float]] = []  # (bytes, seconds)

    def observe(self, seconds: float, nbytes: float = 0.0) -> None:
        if seconds < 0 or not math.isfinite(seconds):
            return
        self._history.append((float(max(nbytes, 0.0)), float(seconds)))
        if len(self._history) > self.window:
            self._history.pop(0)

    @property
    def n_observations(self) -> int:
        return len(self._history)

    def predict(self, nbytes: float | None = None) -> float:
        """Predicted duration for a checkpoint of ``nbytes`` (or 'like recent')."""
        if not self._history:
            return self.default_seconds
        xs = [b for b, _ in self._history]
        ys = [s for _, s in self._history]
        n = len(xs)
        if nbytes is not None and n >= 2 and (max(xs) - min(xs)) > 1e-9:
            # least squares fit duration = a + b * bytes
            mx = sum(xs) / n
            my = sum(ys) / n
            sxx = sum((x - mx) ** 2 for x in xs)
            sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            b = sxy / sxx
            a = my - b * mx
            pred = a + b * float(nbytes)
            if math.isfinite(pred) and pred > 0:
                return pred
        # EMA fallback (recent-weighted)
        ema = ys[0]
        for y in ys[1:]:
            ema = 0.5 * ema + 0.5 * y
        return max(ema, 0.0)


@dataclass(frozen=True)
class AdaptiveCheckpointPolicy:
    """Steerable policy parameters (see core/params.py for runtime steering)."""

    mode: str = "adaptive"  # "fixed" | "adaptive"
    #: fixed mode: checkpoint every N iterations (the paper's baseline: 512).
    every_iterations: int = 512
    #: adaptive mode: weak upper bound on ckpt_time / total_time.
    max_fraction: float = 0.05
    #: adaptive mode: force a checkpoint after this much wall time without one.
    max_interval_seconds: float = float("inf")
    #: never checkpoint more often than this (thrash guard).
    min_interval_seconds: float = 0.0
    #: use the duration predictor to stay close to the bound from below.
    use_predictor: bool = True
    #: wall-time budget for the whole run (queue allocation); None = unlimited.
    queue_seconds: float | None = None
    #: safety margin multiplier applied to the predicted final-ckpt duration.
    deadline_safety: float = 2.0

    def validate(self) -> None:
        if self.mode not in ("fixed", "adaptive"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if not (0.0 < self.max_fraction <= 1.0):
            raise ValueError("max_fraction must be in (0, 1]")
        if self.every_iterations < 1:
            raise ValueError("every_iterations must be >= 1")
        if self.max_interval_seconds <= 0:
            raise ValueError("max_interval_seconds must be positive")
        if self.min_interval_seconds < 0:
            raise ValueError("min_interval_seconds must be >= 0")


@dataclass(frozen=True)
class Decision:
    checkpoint: bool
    reason: str
    fraction: float
    predicted_seconds: float

    def __bool__(self) -> bool:  # pragma: no cover - sugar
        return self.checkpoint


class AdaptiveCheckpointController:
    """Decides when to checkpoint, from profiling measurements.

    The controller is deliberately *pure with respect to time*: callers pass in
    ``now`` (wall clock), ``total_seconds`` and ``checkpoint_seconds`` (usually
    read from the timer DB), so it is trivially testable and replayable.
    """

    def __init__(self, policy: AdaptiveCheckpointPolicy) -> None:
        policy.validate()
        self.policy = policy
        self.predictor = CheckpointDurationPredictor()
        self._last_checkpoint_at: float | None = None
        self._started_at: float | None = None
        self._final_done = False
        self.n_checkpoints = 0
        self.n_suppressed = 0
        self.decisions: list[Decision] = []

    # -- lifecycle ------------------------------------------------------------
    def start_run(self, now: float) -> None:
        self._started_at = now
        if self._last_checkpoint_at is None:
            self._last_checkpoint_at = now

    @property
    def started_at(self) -> float:
        return self._started_at if self._started_at is not None else 0.0

    def observe_checkpoint(self, now: float, seconds: float, nbytes: float = 0.0) -> None:
        """Record a completed checkpoint (feeds the predictor and interval)."""
        self.predictor.observe(seconds, nbytes)
        self._last_checkpoint_at = now
        self.n_checkpoints += 1

    # -- the decision ------------------------------------------------------------
    def decide(
        self,
        *,
        iteration: int,
        now: float,
        total_seconds: float,
        checkpoint_seconds: float,
        next_checkpoint_bytes: float | None = None,
    ) -> Decision:
        p = self.policy
        predicted = self.predictor.predict(next_checkpoint_bytes)
        fraction = checkpoint_seconds / total_seconds if total_seconds > 0 else 0.0

        decision = self._decide_inner(
            iteration=iteration,
            now=now,
            total_seconds=total_seconds,
            checkpoint_seconds=checkpoint_seconds,
            fraction=fraction,
            predicted=predicted,
        )
        if not decision.checkpoint:
            self.n_suppressed += 1
        self.decisions.append(decision)
        return decision

    def _decide_inner(
        self,
        *,
        iteration: int,
        now: float,
        total_seconds: float,
        checkpoint_seconds: float,
        fraction: float,
        predicted: float,
    ) -> Decision:
        p = self.policy

        if p.mode == "fixed":
            do = iteration > 0 and iteration % p.every_iterations == 0
            return Decision(do, "fixed-interval" if do else "fixed-interval-skip", fraction, predicted)

        since_last = (
            now - self._last_checkpoint_at if self._last_checkpoint_at is not None else float("inf")
        )

        # (0) queue deadline: force the reliable final checkpoint.
        if p.queue_seconds is not None and self._started_at is not None and not self._final_done:
            remaining = (self._started_at + p.queue_seconds) - now
            if remaining <= p.deadline_safety * predicted:
                self._final_done = True
                return Decision(True, "queue-deadline-final", fraction, predicted)

        # (1) fault-tolerance floor: overrides the fraction bound.
        if since_last >= p.max_interval_seconds:
            return Decision(True, "max-interval", fraction, predicted)

        # (2) thrash guard.
        if since_last < p.min_interval_seconds:
            return Decision(False, "min-interval", fraction, predicted)

        # (3) weak upper bound (paper): never start while above the bound.
        if fraction > p.max_fraction:
            return Decision(False, "fraction-bound", fraction, predicted)

        # (4) predictor-aware admission (beyond-paper): checkpoint as early as
        # the bound allows, so the realised fraction tracks the bound from below.
        if p.use_predictor and self.predictor.n_observations > 0:
            lookahead = (checkpoint_seconds + predicted) / max(total_seconds + predicted, 1e-12)
            if lookahead <= p.max_fraction:
                return Decision(True, "predictor-admit", fraction, predicted)
            return Decision(False, "predictor-defer", fraction, predicted)

        # No history yet: admit (we are under the bound).
        return Decision(True, "under-bound", fraction, predicted)

    # -- reporting -----------------------------------------------------------
    def summary(self) -> dict:
        return {
            "mode": self.policy.mode,
            "n_checkpoints": self.n_checkpoints,
            "n_suppressed": self.n_suppressed,
            "max_fraction": self.policy.max_fraction,
            "max_interval_seconds": self.policy.max_interval_seconds,
            "predictor_observations": self.predictor.n_observations,
            "predicted_next_seconds": self.predictor.predict(),
        }
