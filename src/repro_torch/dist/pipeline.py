"""Fleet-level assignment plans of the pipeline schedule, free of any
framework: the parts :class:`~repro_torch.adapt.StragglerResponse` needs.

* :class:`MicrobatchPlan` — weighted largest-remainder split of the global
  microbatch count across data-parallel hosts (every active host >= 1).
* :class:`StagePlan` — the same apportionment over *pipeline stage depth*:
  ``n_layers`` contiguous layers split across stages by capacity weight
  (every stage >= 1 layer), so the straggler-response controller can *move
  stage boundaries* at run time (``restage``).

Packing a parameter stack into stage slots (``StagePlan.pack``/``unpack``),
the 1F1B tick ranges (``phase_ticks``) and the schedules themselves
(``PipelineStep``, ``gpipe_forward``) come with the distribution slice
(ROADMAP Queue 1).
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping
from dataclasses import dataclass, field

__all__ = ["MicrobatchPlan", "StagePlan"]


# ---------------------------------------------------------------------------
# Weighted largest-remainder apportionment (shared by both plan types)
# ---------------------------------------------------------------------------

def _largest_remainder(weights: Mapping[int, float], total: int) -> dict[int, int]:
    """Apportion ``total`` indivisible units over ``weights`` proportionally.

    Every key receives at least one unit (one unit per key is reserved before
    the proportional split; the remainder is rounded largest-remainder with
    the key id as the deterministic tie-break).  The result satisfies the
    quota rule on the non-reserved part: each share is ``1 + floor(q)`` or
    ``1 + ceil(q)`` for quota ``q = extra * w / sum(w)`` — the invariant the
    property tests in ``tests/test_properties.py`` pin.
    """
    keys = sorted(weights)
    if not keys:
        raise ValueError("cannot apportion over an empty weight map")
    if total < len(keys):
        raise ValueError(
            f"total={total} cannot cover {len(keys)} entries with >= 1 each"
        )
    total_w = sum(weights.values())
    extra = total - len(keys)  # one reserved per key
    quotas = {k: extra * weights[k] / total_w for k in keys}
    counts = {k: int(quotas[k]) for k in keys}
    leftover = extra - sum(counts.values())
    by_remainder = sorted(keys, key=lambda k: (counts[k] - quotas[k], k))
    for k in by_remainder[:leftover]:
        counts[k] += 1
    return {k: counts[k] + 1 for k in keys}


@dataclass
class MicrobatchPlan:
    """Weighted assignment of ``n_micro`` microbatches to data-parallel hosts.

    ``weights`` maps each active host to a positive weight; :meth:`shares`
    apportions the global microbatch count proportionally (largest-remainder
    rounding) with every active host guaranteed at least one microbatch, so a
    rebalanced host still participates until it is explicitly evicted.
    """

    n_micro: int
    weights: dict[int, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.n_micro < max(len(self.weights), 1):
            raise ValueError(
                f"n_micro={self.n_micro} cannot cover {len(self.weights)} hosts "
                f"with at least one microbatch each"
            )
        for host, w in self.weights.items():
            if w <= 0.0:
                raise ValueError(f"host {host} weight must be positive, got {w}")

    @classmethod
    def equal(cls, hosts: Iterable[int], n_micro: int) -> MicrobatchPlan:
        """Uniform plan over ``hosts`` (the pre-adaptation default)."""
        return cls(n_micro=n_micro, weights={int(h): 1.0 for h in hosts})

    @property
    def hosts(self) -> list[int]:
        return sorted(self.weights)

    def set_weight(self, host: int, weight: float) -> None:
        if host not in self.weights:
            raise ValueError(f"host {host} is not in the plan {self.hosts}")
        if weight <= 0.0:
            raise ValueError(f"weight must be positive, got {weight}")
        self.weights[host] = float(weight)

    def evict(self, host: int) -> None:
        """Remove ``host``; its share is re-apportioned among survivors."""
        if host not in self.weights:
            raise ValueError(f"host {host} is not in the plan {self.hosts}")
        if len(self.weights) <= 1:
            raise ValueError("cannot evict the last host in the plan")
        del self.weights[host]

    def shares(self) -> dict[int, int]:
        """{host: microbatch count}; counts sum to ``n_micro``, each >= 1."""
        if not self.weights:
            raise ValueError("plan has no hosts")
        return _largest_remainder(self.weights, self.n_micro)

    def retarget(self, hosts: Iterable[int]) -> MicrobatchPlan:
        """Re-apportion onto a different host set (restore into an N→M
        topology).  Hosts present in both keep their learned capacity
        weights; new hosts enter at the carried mean weight, so a restored
        fleet neither punishes newcomers nor forgets which survivors were
        derated.  The largest-remainder :meth:`shares` then re-splits the
        same ``n_micro`` across the new set."""
        hosts = [int(h) for h in hosts]
        if not hosts:
            raise ValueError("cannot retarget onto an empty host set")
        mean = sum(self.weights.values()) / len(self.weights)
        return MicrobatchPlan(
            n_micro=self.n_micro,
            weights={h: float(self.weights.get(h, mean)) for h in hosts},
        )

    def share(self, host: int) -> int:
        return self.shares()[host]


@dataclass
class StagePlan:
    """Weighted split of ``n_layers`` contiguous layers across pipeline stages.

    The stage-depth analogue of :class:`MicrobatchPlan`: ``weights`` maps each
    pipeline stage (rank along the pipeline mesh axis) to a positive capacity
    weight, and :meth:`depths` apportions the layer count proportionally
    (largest-remainder, every stage >= 1 layer).  The straggler-response
    controller derates a slow stage-owner's weight (``restage`` action) so the
    stage boundary moves and the slow device runs fewer layers per microbatch.
    """

    n_layers: int
    weights: dict[int, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.weights:
            raise ValueError("StagePlan needs at least one stage")
        if self.n_layers < len(self.weights):
            raise ValueError(
                f"n_layers={self.n_layers} cannot cover {len(self.weights)} "
                f"stages with at least one layer each"
            )
        for stage, w in self.weights.items():
            if w <= 0.0:
                raise ValueError(f"stage {stage} weight must be positive, got {w}")

    @classmethod
    def equal(cls, stages: Iterable[int], n_layers: int) -> StagePlan:
        """Uniform plan over ``stages`` (the pre-adaptation default)."""
        return cls(n_layers=n_layers, weights={int(s): 1.0 for s in stages})

    @property
    def stages(self) -> list[int]:
        return sorted(self.weights)

    @property
    def n_stages(self) -> int:
        return len(self.weights)

    def set_weight(self, stage: int, weight: float) -> None:
        if stage not in self.weights:
            raise ValueError(f"stage {stage} is not in the plan {self.stages}")
        if weight <= 0.0:
            raise ValueError(f"weight must be positive, got {weight}")
        self.weights[stage] = float(weight)

    def depths(self) -> dict[int, int]:
        """{stage: layer count}; counts sum to ``n_layers``, each >= 1."""
        return _largest_remainder(self.weights, self.n_layers)

    def retarget(self, stages: Iterable[int]) -> StagePlan:
        """Re-apportion the same ``n_layers`` onto a different stage set
        (restore into an N→M pipeline).  Stages present in both keep their
        learned capacity weights; new stages enter at the carried mean, and
        :meth:`depths` re-splits the layer stack."""
        stages = [int(s) for s in stages]
        if not stages:
            raise ValueError("cannot retarget onto an empty stage set")
        if self.n_layers < len(stages):
            raise ValueError(
                f"n_layers={self.n_layers} cannot cover {len(stages)} stages"
            )
        mean = sum(self.weights.values()) / len(self.weights)
        return StagePlan(
            n_layers=self.n_layers,
            weights={s: float(self.weights.get(s, mean)) for s in stages},
        )

    def boundaries(self) -> dict[int, tuple[int, int]]:
        """{stage: [start, stop) layer range} in stage order."""
        depths = self.depths()
        out: dict[int, tuple[int, int]] = {}
        start = 0
        for stage in self.stages:
            out[stage] = (start, start + depths[stage])
            start += depths[stage]
        return out

    def max_depth(self) -> int:
        return max(self.depths().values())
