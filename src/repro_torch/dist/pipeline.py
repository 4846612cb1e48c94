"""Pipeline parallelism over one mesh axis: forward-only GPipe and 1F1B,
and the fleet-level assignment plans above them.

The reference runs both schedules as one SPMD program (``shard_map`` over
the pipeline axis with ``ppermute`` rings).  The port keeps its single
controller and its tick formulas: pipeline rank ``d`` computes on
``mesh.devices[d]`` (the first device of its submesh), and a ring send is a
``.to()`` onto the next rank's device, delivered at tick ``t + 1``.  Several
ranks may share one device when the :class:`~repro_torch.dist.meshutil.Mesh`
is built that way; they then run one after another.

``gpipe_forward`` places consecutive layer stages on consecutive ranks and
streams microbatches through them: at tick ``t`` rank 0 ingests microbatch
``t`` while every other rank works on the activation its predecessor
shipped at tick ``t-1``.  After ``n_micro + n_stages - 1`` ticks the last
rank has emitted every microbatch.

:class:`PipelineStep` / :func:`pipeline_step` add the training schedule: a
**1F1B** (one-forward-one-backward) tick loop that returns the loss *and*
per-slot parameter gradients, driven by one global tick clock ``t``:

* rank ``d`` runs the *forward* of microbatch ``m`` at tick ``m + d``;
* rank ``d`` runs the *backward* of microbatch ``m`` at tick
  ``m + 2S - 1 - d`` (``S`` = pipeline depth), i.e. the loss gradient enters
  the last rank one tick after that microbatch's forward leaves it.

Ticks ``[0, S)`` are **warmup**, ``[S, M + S - 1)`` **steady state** and
``[M + S - 1, M + 2S - 1)`` **cooldown**; :func:`phase_ticks` exposes these
ranges and :class:`PipelineStep` runs them as three timed segments when
given ``phase_cb``.  Each rank keeps only its in-flight stage inputs in a
ring stash of ``min(2S, M)`` slots; the backward recomputes the rank's
stage from the stashed input under autograd (the stage recompute is the
remat) and takes the VJP with ``torch.autograd.grad``.

Unlike the reference, which computes every slot and discards the padded
ones, a slot that the stage mask marks inactive runs nothing, and
``last_fn`` runs on the last rank only: the results are equal and the
kernel launches are exactly those of the active layers.

Fleet-level assignment objects sit above the schedules:

* :class:`MicrobatchPlan` — weighted largest-remainder split of the global
  microbatch count across data-parallel hosts (every active host >= 1).
* :class:`StagePlan` — the same apportionment over *pipeline stage depth*:
  ``n_layers`` contiguous layers split across stages by capacity weight
  (every stage >= 1 layer).  :meth:`StagePlan.pack` turns a flat per-layer
  parameter stack into the padded ``(n_stages * max_depth, ...)`` slot
  layout (+ active mask) that :class:`PipelineStep` executes, so the
  straggler-response controller can *move stage boundaries* at run time
  (``restage``) and the very next step executes the new split.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Mapping
from dataclasses import dataclass, field
from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map
from .meshutil import Mesh, pipeline_submeshes

__all__ = [
    "MicrobatchPlan",
    "PipelineStep",
    "StagePlan",
    "gpipe_forward",
    "phase_ticks",
    "pipeline_step",
]


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

    :meth:`pack` / :meth:`unpack` translate between the flat per-layer
    parameter stack and the padded per-stage slot layout
    (``n_stages * max_depth`` rows + active mask) that :class:`PipelineStep`
    executes, so a launcher applies a restage by simply re-packing before the
    next step.
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
        :meth:`depths` re-splits the layer stack — the flat per-layer
        parameter checkpoint then :meth:`pack`\\ s into the new topology
        without any tensor surgery."""
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

    def pack(self, layer_params) -> tuple[Any, torch.Tensor]:
        """Pad a flat per-layer parameter tree into pipeline slots.

        ``layer_params`` is a tensor or any tree whose leaves share a leading
        ``n_layers`` dimension (a transformer block stack).  Returns
        ``(packed, mask)``: every packed leaf (on its leaf's device) has
        leading ``n_stages * max_depth`` where stage ``s`` owns the
        contiguous slot block ``[s * max_depth, (s+1) * max_depth)`` holding
        its layers front-aligned, the padding zero; ``mask`` is the matching
        boolean slot-activity vector, on the CPU: schedule metadata the
        host reads (inactive slots run nothing in the pipeline and receive
        zero gradient).
        """
        lmax, rows = self._slot_rows()
        n_slots = self.n_stages * lmax

        def _pack_leaf(leaf):
            if int(leaf.shape[0]) != self.n_layers:
                raise ValueError(
                    f"layer_params leaf has {leaf.shape[0]} layers, plan "
                    f"covers {self.n_layers}"
                )
            index = torch.tensor(rows, device=leaf.device)
            out = leaf.new_zeros((n_slots,) + tuple(leaf.shape[1:]))
            return out.index_copy_(0, index, leaf)

        packed = tree_map(_pack_leaf, layer_params)
        mask = torch.zeros((n_slots,), dtype=torch.bool)
        mask[rows] = True
        return packed, mask

    def unpack(self, packed):
        """Gather the active slots of a packed tree (e.g. per-slot
        gradients) back into the flat ``(n_layers, ...)`` layer order."""
        lmax, rows = self._slot_rows()

        def _unpack_leaf(leaf):
            if int(leaf.shape[0]) != self.n_stages * lmax:
                raise ValueError(
                    f"packed leaf has {leaf.shape[0]} slots, plan packs to "
                    f"{self.n_stages * lmax}"
                )
            return leaf.index_select(0, torch.tensor(rows, device=leaf.device))

        return tree_map(_unpack_leaf, packed)

    def _slot_rows(self) -> tuple[int, list[int]]:
        """``(max_depth, slot index of each flat layer in layer order)`` —
        one apportionment pass serves both pack() and unpack(), which sit on
        the per-step hot path (the live-restage re-pack)."""
        depths = self.depths()
        lmax = max(depths.values())
        rows: list[int] = []
        for i, stage in enumerate(self.stages):
            rows.extend(i * lmax + j for j in range(depths[stage]))
        return lmax, rows


# ---------------------------------------------------------------------------
# Ranks of the pipeline axis
# ---------------------------------------------------------------------------

def _rank_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The device each rank of ``axis`` computes on: the first device of its
    submesh (a stage's other devices would hold replicas: per-stage
    sharding over inner axes is not ported)."""
    return [sub.devices.flat[0] for sub in pipeline_submeshes(mesh, axis)]


def _check_preserved(out: torch.Tensor, shape, dtype, what: str = "layer_fn") -> None:
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(
            f"{what} must preserve activation shape/dtype for pipelining; "
            f"got {tuple(out.shape)}/{out.dtype} from {tuple(shape)}/{dtype}"
        )


# ---------------------------------------------------------------------------
# Forward-only (GPipe) schedule
# ---------------------------------------------------------------------------

def gpipe_forward(
    layer_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: torch.Tensor,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str,
    n_micro: int,
) -> torch.Tensor:
    """Run ``x`` through stacked stages pipelined over ``mesh`` axis ``axis``.

    ``stage_params`` has a leading stage dimension (``n_stages, ...``); stage
    ``i`` computes ``layer_fn(stage_params[i], activation)`` and must preserve
    the activation's shape and dtype (homogeneous pipeline).  ``n_stages`` must
    be a multiple of the mesh axis size (each rank runs a contiguous group of
    stages) and ``x.shape[0]`` a multiple of ``n_micro``.  Returns the output
    on ``x``'s device.
    """
    n_stages = int(stage_params.shape[0])
    axis_size = int(mesh.shape[axis])
    if n_stages % axis_size != 0:
        raise ValueError(
            f"n_stages={n_stages} must be a multiple of mesh axis {axis!r} "
            f"size {axis_size}"
        )
    batch = int(x.shape[0])
    if batch % n_micro != 0:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")
    micro = x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))
    devices = _rank_devices(mesh, axis)
    per_rank = n_stages // axis_size
    blocks = [
        [stage_params[i].to(devices[d]) for i in range(d * per_rank, (d + 1) * per_rank)]
        for d in range(axis_size)
    ]
    outputs: list[torch.Tensor | None] = [None] * n_micro
    inflight: list[torch.Tensor | None] = [None] * axis_size
    with torch.no_grad():
        for t in range(n_micro + axis_size - 1):
            produced: list[torch.Tensor | None] = [None] * axis_size
            for d in range(axis_size):
                mf = t - d
                if not 0 <= mf < n_micro:
                    continue
                act = micro[mf].to(devices[d]) if d == 0 else inflight[d]
                for w in blocks[d]:
                    out = layer_fn(w, act)
                    _check_preserved(out, micro.shape[1:], x.dtype)
                    act = out
                produced[d] = act
                if d == axis_size - 1:
                    outputs[mf] = act.to(x.device)
            # the ring: what rank d produced reaches rank d + 1 at tick t + 1
            inflight = [None] + [
                None if produced[d - 1] is None else produced[d - 1].to(devices[d])
                for d in range(1, axis_size)
            ]
    return torch.cat(outputs, dim=0)


# ---------------------------------------------------------------------------
# 1F1B training schedule
# ---------------------------------------------------------------------------

def phase_ticks(n_micro: int, axis_size: int) -> dict[str, tuple[int, int]]:
    """The 1F1B global tick ranges: ``{phase: [start, stop)}``.

    *warmup* is the forward fill (no backward active anywhere), *steady* the
    one-forward-one-backward regime, *cooldown* the backward drain (no forward
    active anywhere).  The full schedule is ``n_micro + 2 * axis_size - 1``
    ticks; ranges may be empty (e.g. steady when ``n_micro < axis_size``).
    """
    s, m = int(axis_size), int(n_micro)
    return {
        "warmup": (0, s),
        "steady": (s, max(m + s - 1, s)),
        "cooldown": (max(m + s - 1, s), m + 2 * s - 1),
    }


def _on(tree, device: torch.device):
    """Detached leaves of ``tree`` on ``device`` that autograd differentiates
    to (a view, not a copy, where the leaf already lives there)."""
    return tree_map(lambda leaf: leaf.detach().to(device).requires_grad_(), tree)


def _accumulate(acc_leaves: list[torch.Tensor], grads, row: int | None = None) -> None:
    """Add ``grads`` into the accumulators (row ``row`` of each), in the
    accumulator's dtype: each leaf's own, as the reference's are."""
    for acc, g in zip(acc_leaves, grads):
        (acc if row is None else acc[row]).add_(g.to(acc.device))


@dataclass
class _Call:
    """One call's inputs, accumulators and the schedule's state between
    ticks (and between phase segments)."""

    slots: list           # per rank: (slot row, its leaves on the rank's device)
    micro: torch.Tensor   # (M, micro batch, ...) inputs
    tmicro: torch.Tensor  # (M, micro batch, ...) targets
    gacc: list            # per-slot gradient accumulators, flat like stage_params
    first: Any            # first_params' leaves on rank 0's device (hooks)
    last: Any             # last_params' leaves on the last rank's device (hooks)
    facc: list            # first_params' gradient accumulators
    lacc: list            # last_params' gradient accumulators
    stash: list           # per rank: ring of (stage input, loss seed) by slot
    loss: torch.Tensor    # f32, on the last rank's device
    recv_f: list          # activation each rank receives at this tick
    recv_b: list          # activation gradient each rank receives
    stash_peak: int = 0   # most stage inputs one rank held at once


class PipelineStep:
    """Reusable 1F1B pipeline train step over one mesh axis.

    Every ``__call__`` executes the schedule and returns ``(loss, grads)``
    where ``loss`` is the mean of the per-microbatch loss (an f32 0-d tensor
    on the last rank's device) and ``grads`` matches ``stage_params``'s
    structure (per-slot parameter gradients of that mean loss, in each
    leaf's dtype, on each leaf's device).

    ``stage_params`` may be a bare ``(n_slots, ...)`` tensor or any tree
    whose leaves share the leading slot dimension (e.g. a transformer block
    stack) — :meth:`StagePlan.pack` produces either.

    Parameters
    ----------
    layer_fn:
        ``layer_fn(slot_params, activation) -> activation`` — must preserve
        activation shape/dtype (homogeneous pipeline).  ``slot_params`` is
        one slot's slice of the ``stage_params`` tree.
    loss_fn:
        ``loss_fn(final_activation, target_microbatch) -> scalar``; it is
        evaluated (and differentiated) on the last rank only.  ``None`` is
        allowed iff ``last_fn`` is given (the head then owns the loss).
    mesh / axis:
        The pipeline mesh axis.  The slot count must be a multiple of the
        axis size; each rank runs a contiguous slot block.
    n_micro:
        Microbatch count ``M``; ``x.shape[0]`` must be divisible by it.
    first_fn / last_fn:
        Stage-pinning hooks for heterogeneous ends of the pipeline (both or
        neither).  ``first_fn(first_params, raw_microbatch) -> activation``
        runs on rank 0 (the embedding: ``x`` then carries raw inputs, e.g.
        int32 tokens); ``last_fn(last_params, activation, target_microbatch)
        -> scalar`` runs on the last rank (norm + head + loss) and replaces
        ``loss_fn``.  ``__call__`` then takes ``first_params`` /
        ``last_params`` and returns ``(loss, (stage_grads, first_grads,
        last_grads))``.
    phase_cb:
        Optional ``phase_cb(name) -> context manager`` for
        ``warmup``/``steady``/``cooldown``.  When set, the schedule runs as
        three segments with the callback's context open around each, and
        each segment synchronizes the card before its context closes, so a
        scope times the phase's device work, not just its dispatch.
    stage_spec:
        Per-stage tensor-parallel/FSDP sharding over the mesh's inner axes:
        not yet ported (raises).
    """

    def __init__(
        self,
        layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None,
        *,
        mesh: Mesh,
        axis: str,
        n_micro: int,
        first_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
        last_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
        phase_cb: Callable[[str], object] | None = None,
        stage_spec: Any | None = None,
    ) -> None:
        if (first_fn is None) != (last_fn is None):
            raise ValueError(
                "first_fn and last_fn pin the pipeline's heterogeneous ends "
                "together: pass both or neither"
            )
        if loss_fn is None and last_fn is None:
            raise ValueError("loss_fn may only be None when last_fn is given")
        if stage_spec is not None:
            raise NotImplementedError(
                "stage_spec (per-stage tensor-parallel/FSDP sharding of the "
                "stage parameters) is not yet ported (ROADMAP Queue 1 item 6, "
                "dist/sharding.py)"
            )
        self.layer_fn = layer_fn
        self.loss_fn = loss_fn
        self.first_fn = first_fn
        self.last_fn = last_fn
        self.mesh = mesh
        self.axis = axis
        self.n_micro = int(n_micro)
        self.phase_cb = phase_cb
        self.axis_size = int(mesh.shape[axis])
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.devices = _rank_devices(mesh, axis)
        #: the most stage inputs one rank held at once in the last call
        self.last_stash_peak = 0

    # -- public entry ---------------------------------------------------------
    def __call__(
        self,
        stage_params: Any,
        x: torch.Tensor,
        targets: torch.Tensor,
        stage_mask: torch.Tensor | None = None,
        *,
        first_params: Any = None,
        last_params: Any = None,
    ):
        s, m = self.axis_size, self.n_micro
        hooks = self.last_fn is not None
        if hooks and (first_params is None or last_params is None):
            raise ValueError(
                "first_params/last_params are required when first_fn/last_fn "
                "are set"
            )
        if not hooks and (first_params is not None or last_params is not None):
            raise ValueError(
                "first_params/last_params given but the step has no "
                "first_fn/last_fn"
            )
        leaves = tree_leaves(stage_params)
        if not leaves:
            raise ValueError("stage_params has no array leaves")
        n_slots = int(leaves[0].shape[0])
        for leaf in leaves:
            if int(leaf.shape[0]) != n_slots:
                raise ValueError(
                    f"stage_params leaves disagree on the slot dimension: "
                    f"{leaf.shape[0]} != {n_slots}"
                )
        if n_slots % s != 0:
            raise ValueError(
                f"n_slots={n_slots} must be a multiple of mesh axis "
                f"{self.axis!r} size {s}"
            )
        batch = int(x.shape[0])
        if batch % m != 0:
            raise ValueError(f"batch {batch} not divisible by n_micro={m}")
        if int(targets.shape[0]) != batch:
            raise ValueError(
                f"targets leading dim {targets.shape[0]} != batch {batch}"
            )
        if stage_mask is None:
            active = [True] * n_slots
        elif tuple(stage_mask.shape) != (n_slots,):
            raise ValueError(
                f"stage_mask shape {tuple(stage_mask.shape)} != ({n_slots},)"
            )
        else:
            active = [bool(a) for a in stage_mask.tolist()]

        per_rank = n_slots // s
        r = min(2 * s, m)
        zeros = lambda tree: [torch.zeros_like(leaf) for leaf in tree_leaves(tree)]  # noqa: E731
        c = _Call(
            # each rank's active slots, as leaves on its device; padded
            # slots are never touched (no launch, zero gradient)
            slots=[[(i, _on(tree_map(lambda leaf, i=i: leaf[i], stage_params), dev))
                    for i in range(d * per_rank, (d + 1) * per_rank) if active[i]]
                   for d, dev in enumerate(self.devices)],
            micro=x.reshape((m, batch // m) + tuple(x.shape[1:])),
            tmicro=targets.reshape((m, batch // m) + tuple(targets.shape[1:])),
            gacc=zeros(stage_params),
            first=_on(first_params, self.devices[0]) if hooks else None,
            last=_on(last_params, self.devices[-1]) if hooks else None,
            facc=zeros(first_params) if hooks else [],
            lacc=zeros(last_params) if hooks else [],
            stash=[[None] * r for _ in range(s)],
            loss=torch.zeros((), dtype=torch.float32, device=self.devices[-1]),
            recv_f=[None] * s, recv_b=[None] * s,
        )
        if self.phase_cb is None:
            self._run(c, 0, m + 2 * s - 1)
        else:
            for name, (t0, t1) in phase_ticks(m, s).items():
                if t1 <= t0:
                    continue
                with self.phase_cb(name):
                    self._run(c, t0, t1)
                    # inside the scope: the caliper window covers the
                    # phase's device work, not just its dispatch
                    self._sync()
        self.last_stash_peak = c.stash_peak
        it = iter(c.gacc)
        grads = tree_map(lambda _: next(it), stage_params)
        if not hooks:
            return c.loss, grads
        it_f, it_l = iter(c.facc), iter(c.lacc)
        return c.loss, (grads, tree_map(lambda _: next(it_f), first_params),
                        tree_map(lambda _: next(it_l), last_params))

    # -- the schedule ---------------------------------------------------------
    def _sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def _local(self, c: _Call, d: int, act: torch.Tensor) -> torch.Tensor:
        """Rank ``d``'s active slots applied in order."""
        for _, slot in c.slots[d]:
            out = self.layer_fn(slot, act)
            _check_preserved(out, act.shape, act.dtype)
            act = out
        return act

    def _head(self, c: _Call, y: torch.Tensor, tgt: torch.Tensor):
        """Value and gradient of the loss at a forward tick on the last rank:
        ``(loss, d loss / d y, d loss / d last_params)``."""
        live = y.detach().requires_grad_()
        with torch.enable_grad():
            if self.last_fn is not None:
                lm = self.last_fn(c.last, live, tgt)
                wrt = [live] + tree_leaves(c.last)
            else:
                lm = self.loss_fn(live, tgt)
                wrt = [live]
            if lm.shape != ():
                raise ValueError(
                    f"loss_fn must return a scalar, got shape {tuple(lm.shape)}"
                )
            grads = torch.autograd.grad(lm, wrt)
        return lm.detach(), grads[0], grads[1:]

    def _run(self, c: _Call, t0: int, t1: int) -> None:
        s, m = self.axis_size, self.n_micro
        r = min(2 * s, m)
        hooks = self.last_fn is not None
        last = s - 1
        for t in range(t0, t1):
            send_f: list = [None] * s
            send_b: list = [None] * s
            for d, dev in enumerate(self.devices):
                # ---- forward: microbatch t - d ----
                mf = t - d
                if 0 <= mf < m:
                    with torch.no_grad():
                        if d == 0:
                            act = c.micro[mf].to(dev)
                            if hooks:
                                act = self.first_fn(c.first, act)
                                if not isinstance(act, torch.Tensor):
                                    raise ValueError("first_fn must return a single array")
                        else:
                            act = c.recv_f[d]
                        y = self._local(c, d, act)
                    seed = None
                    if d == last:
                        # fold the loss in and keep its gradient seed for the
                        # backward tick one step later
                        lm, gm, glast = self._head(c, y, c.tmicro[mf].to(dev))
                        c.loss = c.loss + (lm / m).float()
                        seed = gm / m
                        if hooks:
                            _accumulate(c.lacc, [g / m for g in glast])
                    slot = mf % r
                    if c.stash[d][slot] is not None:
                        raise RuntimeError(
                            f"1F1B stash collision: rank {d} tick {t} slot {slot}")
                    c.stash[d][slot] = (act, seed)
                    c.stash_peak = max(c.stash_peak, sum(e is not None for e in c.stash[d]))
                    send_f[d] = y
                # ---- backward: microbatch t - (2S - 1 - d) ----
                mb = t - (2 * s - 1 - d)
                if 0 <= mb < m:
                    slot = mb % r
                    act_b, seed = c.stash[d][slot]
                    c.stash[d][slot] = None
                    g_in = seed if d == last else c.recv_b[d]
                    dact = self._stage_vjp(c, d, act_b, g_in, need_dact=d > 0 or hooks)
                    if hooks and d == 0:
                        # rank 0's activation gradient flows into the pinned
                        # first_fn (the embedding): its VJP from the raw input
                        with torch.enable_grad():
                            emb = self.first_fn(c.first, c.micro[mb].to(dev))
                            _accumulate(c.facc, torch.autograd.grad(
                                emb, tree_leaves(c.first), dact))
                    send_b[d] = dact
            # the rings: rank d's output reaches rank d + 1, its activation
            # gradient rank d - 1, at tick t + 1 (rank 0 feeds from the input
            # and the last rank from its seed, so the wrap-around is not sent)
            c.recv_f = [None] + [
                None if send_f[d - 1] is None else send_f[d - 1].to(self.devices[d])
                for d in range(1, s)
            ]
            c.recv_b = [
                None if send_b[d + 1] is None else send_b[d + 1].to(self.devices[d])
                for d in range(s - 1)
            ] + [None]

    def _stage_vjp(self, c: _Call, d: int, act: torch.Tensor, g_in: torch.Tensor,
                   need_dact: bool) -> torch.Tensor | None:
        """Recompute rank ``d``'s stage from its stashed input and take the
        VJP: adds the slots' parameter gradients into the accumulators and
        returns the gradient of the stage input (``None`` without
        ``need_dact``)."""
        slots = c.slots[d]
        if not slots:  # every slot padded: the stage is the identity
            return g_in
        with torch.enable_grad():
            live = act.detach().requires_grad_(need_dact)
            y = self._local(c, d, live)
            wrt = [leaf for _, slot in slots for leaf in tree_leaves(slot)]
            grads = torch.autograd.grad(y, ([live] if need_dact else []) + wrt, g_in)
        dact, dw = (grads[0], grads[1:]) if need_dact else (None, grads)
        n = len(c.gacc)
        for k, (row, _) in enumerate(slots):
            _accumulate(c.gacc, dw[k * n:(k + 1) * n], row)
        return dact


def pipeline_step(
    layer_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: torch.Tensor,
    x: torch.Tensor,
    targets: torch.Tensor,
    *,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    axis: str,
    n_micro: int,
    stage_mask: torch.Tensor | None = None,
    phase_cb: Callable[[str], object] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot 1F1B step: ``(loss, per-slot grads)`` for ``x``/``targets``
    (a convenience wrapper over :class:`PipelineStep`)."""
    step = PipelineStep(
        layer_fn, loss_fn, mesh=mesh, axis=axis, n_micro=n_micro,
        phase_cb=phase_cb,
    )
    return step(stage_params, x, targets, stage_mask)
