"""Payback-aware migration: is the re-shard worth it?

Evicting a straggler or admitting a newcomer is not free — the fleet must
durably checkpoint, re-apportion every plan, and rebuild its mesh before the
first post-change step runs.  The Cactus Worm experiments and AdaptCheck both
frame this the same way: move work only when the projected win over a payback
horizon exceeds the cost of moving it.

:class:`ReshardCost` carries the cost side in seconds — seeded from the
committed checkpoint benchmark baselines (``benchmarks/baselines/
checkpoint.json``: measured ``save_sync`` + ``restore_latest`` per-call times)
and updated with live-measured save/restore seconds as the run observes its
own checkpoints (EWMA, so a run on slower disks converges to its own truth).

:class:`PaybackPolicy` turns that into the two gates the control plane calls:

* :meth:`evict_gate` plugs into ``StragglerResponse(reshard_gate=...)`` — the
  projected win of dropping a straggler is the per-step seconds the fleet
  median waits on it, integrated over the horizon;
* :meth:`join_gate` guards mid-run admissions — the projected win of one more
  host is the per-step fleet time recovered by spreading the same microbatches
  wider, integrated over the same horizon.

Either gate returns ``None`` (payback covers the cost: proceed) or the
``ADAPT/fleet::defer_reshard`` :class:`ControlAction` describing exactly why
the move was skipped — every skip is logged, none is silent.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..adapt.controller import ControlAction
from ..dist.stragglers import StragglerReport

__all__ = ["PaybackPolicy", "ReshardCost"]

#: fallback seconds when no baseline file is reachable (the committed
#: tiny-scale CPU numbers, rounded up — a conservative floor, not a model)
_FALLBACK_SAVE_S = 0.006
_FALLBACK_RESTORE_S = 0.003

_BASELINE_ROWS = {"ckpt/save_sync": "save_s", "ckpt/restore_latest": "restore_s"}


def _default_baseline_path() -> str:
    # repo layout: src/repro_torch/fleet/payback.py -> benchmarks/baselines/...
    # That file is data: the JAX package's checkpoint writer timed on a CPU
    # host (Python 3.10), not this package's on a GPU host.  It only seeds the
    # cost: the launcher times its own startup save and restore and folds
    # them in at once (EWMA 0.5, :meth:`ReshardCost.observe`).
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(
        here, "..", "..", "..", "benchmarks", "baselines", "checkpoint.json"
    )


@dataclass
class ReshardCost:
    """Seconds one membership change costs the fleet, by phase."""

    save_s: float = _FALLBACK_SAVE_S
    restore_s: float = _FALLBACK_RESTORE_S
    #: plan re-apportionment + mesh rebuild (usually dwarfed by the I/O)
    rebuild_s: float = 0.0
    #: EWMA weight for live observations folded in via :meth:`observe`
    ewma: float = 0.5

    def total(self) -> float:
        return self.save_s + self.restore_s + self.rebuild_s

    @classmethod
    def from_baseline(cls, path: str | None = None) -> ReshardCost:
        """Seed from the measured checkpoint benchmark baselines (µs/call
        rows); falls back to the conservative defaults when unreadable."""
        path = path or _default_baseline_path()
        kwargs: dict[str, float] = {}
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
            for row in payload.get("rows", ()):
                field = _BASELINE_ROWS.get(row.get("name"))
                if field is not None:
                    kwargs[field] = float(row["us_per_call"]) * 1e-6
        except (OSError, ValueError, KeyError, TypeError):
            pass
        return cls(**kwargs)

    def observe(
        self, save_s: float | None = None, restore_s: float | None = None
    ) -> None:
        """Fold a live-measured save/restore duration into the model."""
        if save_s is not None and save_s > 0.0:
            self.save_s += self.ewma * (float(save_s) - self.save_s)
        if restore_s is not None and restore_s > 0.0:
            self.restore_s += self.ewma * (float(restore_s) - self.restore_s)


class PaybackPolicy:
    """The two membership gates, parameterized by one horizon.

    Parameters
    ----------
    cost:
        The :class:`ReshardCost` both gates amortize against.
    horizon_steps:
        How many future steps a win is credited over before it must cover the
        re-shard cost.  ``0`` means "no future to amortize against" — every
        optional move defers (useful to demonstrate/drill the defer path).
    min_hosts:
        Joins that bring the fleet up to this size bypass the gate: a fleet
        below its provisioned size is rebuilding, not speculating.
    """

    def __init__(
        self, cost: ReshardCost, *, horizon_steps: int = 50, min_hosts: int = 1
    ) -> None:
        if horizon_steps < 0:
            raise ValueError(f"horizon_steps must be >= 0, got {horizon_steps}")
        self.cost = cost
        self.horizon_steps = int(horizon_steps)
        self.min_hosts = int(min_hosts)
        #: defer decisions taken, by reason ("evict" / "join")
        self.defers: dict[str, int] = {"evict": 0, "join": 0}

    # -- gates -------------------------------------------------------------------
    def _defer(
        self, step: int, reason: str, host: int, win_per_step: float
    ) -> ControlAction:
        self.defers[reason] = self.defers.get(reason, 0) + 1
        projected = win_per_step * self.horizon_steps
        return ControlAction(
            step=step,
            controller="fleet",
            trigger=f"DIST/host{host}::step",
            action="defer_reshard",
            detail={
                "reason": reason,
                "host": host,
                "win_per_step_s": round(win_per_step, 6),
                "projected_win_s": round(projected, 6),
                "reshard_cost_s": round(self.cost.total(), 6),
                "horizon_steps": self.horizon_steps,
            },
        )

    def evict_gate(
        self, step: int, host: int, report: StragglerReport, slowdown: float
    ) -> ControlAction | None:
        """``StragglerResponse.reshard_gate`` hook: ``None`` lets the eviction
        proceed; otherwise the returned defer action is recorded instead.

        The win of shedding a straggler is the seconds per step the fleet
        spends waiting past its median on that host.
        """
        win_per_step = max(
            report.host_means.get(host, report.median) - report.median, 0.0
        )
        if win_per_step * self.horizon_steps > self.cost.total():
            return None
        return self._defer(step, "evict", host, win_per_step)

    def join_gate(
        self, step: int, host: int, n_active: int, mean_step_s: float
    ) -> ControlAction | None:
        """``None`` admits the join; otherwise the defer action.

        The win of one more host is the per-step time recovered by spreading
        the same work one way wider: ``mean_step_s * (1 / (n + 1))``.
        """
        if n_active < self.min_hosts:
            return None  # rebuilding to provisioned size is never speculative
        win_per_step = max(mean_step_s, 0.0) / (n_active + 1)
        if win_per_step * self.horizon_steps > self.cost.total():
            return None
        return self._defer(step, "join", host, win_per_step)
