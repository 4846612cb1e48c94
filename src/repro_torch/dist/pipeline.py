"""Pipeline parallelism over one mesh axis: forward-only GPipe and 1F1B,
and the fleet-level assignment plans above them.

The reference runs both schedules as one SPMD program (``shard_map`` over
the pipeline axis with ``ppermute`` rings).  The port runs them in one of
two modes, with the reference's tick formulas in both:

* **single controller** (a :class:`~repro_torch.dist.meshutil.Mesh`): one
  process drives every rank; pipeline rank ``d`` computes on
  ``mesh.devices[d]`` (the first device of its submesh), and a ring send is
  a ``.to()`` onto the next rank's device, delivered at tick ``t + 1``.
  Several ranks may share one device when the ``Mesh`` is built that way;
  they then run one after another.
* **processes** (a 1-d ``("pod",)`` ``DeviceMesh`` over a process group,
  ``meshutil.device_mesh``): one process a rank, its pipeline rank its rank
  in the mesh.  Each process holds only its own stage's parameters and runs
  only its own rank's half of every tick; a ring send is a point-to-point
  message (``dist.p2p``: host-staged on gloo, device tensors on NCCL),
  posted with the tick's receives in one batch at the end of the tick and
  delivered at tick ``t + 1``.  A receiver knows from the tick formulas
  alone whether a message comes, and its shape and dtype from the
  activation's; nothing is sent on the rings' wrap-around edges.  Ranks
  that share a card are separate processes whose kernels the card
  time-slices.

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
given ``phase_cb`` (in the process mode every rank times its own ticks of
each phase, and the ranks meet at a barrier before each phase, as the
reference's three separately dispatched segments all devices enter
together).  Each rank keeps only its in-flight stage inputs in a
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
from .sharding import PartitionSpec

#: message tags of the two rings
_FWD, _BWD = 0, 1

__all__ = [
    "MicrobatchPlan",
    "PipelineStep",
    "StagePlan",
    "gpipe_forward",
    "is_process_mesh",
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


@dataclass
class _Procs:
    """This process's place on a ``DeviceMesh`` pipeline axis."""

    rank: int             # pipeline rank: this process's rank in the mesh axis
    size: int             # pipeline depth S
    peers: list           # global rank of each pipeline rank
    group: Any            # the axis's process group
    device: torch.device  # where this process computes
    transport: Any        # dist.p2p.Transport over the group


def is_process_mesh(mesh: Any) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (one process a rank) rather
    than the single controller's :class:`Mesh`."""
    return not isinstance(mesh, Mesh) and hasattr(mesh, "mesh_dim_names")


def _procs(mesh: Any, axis: str) -> _Procs:
    """The process mode's view of ``axis`` on a 1-d ``DeviceMesh``."""
    import torch.distributed as dist

    from .p2p import Transport

    names = tuple(mesh.mesh_dim_names or ())
    if names != (axis,):
        raise ValueError(f"the process mode pipelines over a 1-d ({axis!r},) DeviceMesh, "
                         f"got axes {names}")
    group = mesh.get_group(axis)
    size = mesh.size()
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    transport = Transport(device, group)
    if transport.backend == "nccl":
        # NCCL needs every rank of the group in its first collective, and a
        # tick's batch_isend_irecv leaves out the ranks that post nothing
        dist.barrier(group=group, device_ids=[device.index])
    return _Procs(rank=mesh.get_local_rank(axis), size=size,
                  peers=[dist.get_global_rank(group, r) for r in range(size)], group=group,
                  device=device, transport=transport)


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

    On a ``DeviceMesh`` (the process mode) ``stage_params`` holds this
    rank's own contiguous group of stages, every rank passes the same
    ``x``, and every rank gets the output (the last rank broadcasts it).
    """
    if is_process_mesh(mesh):
        return _gpipe_procs(layer_fn, stage_params, x, _procs(mesh, axis), n_micro)
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


def _gpipe_procs(layer_fn, stage_params, x, pr: _Procs, n_micro: int) -> torch.Tensor:
    """:func:`gpipe_forward` on one process: this rank's ticks."""
    batch = int(x.shape[0])
    if batch % n_micro != 0:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")
    micro = x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))
    d, s, dev = pr.rank, pr.size, pr.device
    block = [stage_params[i].to(dev) for i in range(int(stage_params.shape[0]))]
    outputs: list[torch.Tensor] = []
    inflight = None
    with torch.no_grad():
        for t in range(n_micro + s - 1):
            sends = []
            mf = t - d
            if 0 <= mf < n_micro:
                act = micro[mf].to(dev) if d == 0 else inflight
                for w in block:
                    out = layer_fn(w, act)
                    _check_preserved(out, micro.shape[1:], x.dtype)
                    act = out
                if d == s - 1:
                    outputs.append(act)
                else:
                    sends.append((pr.peers[d + 1], act, _FWD))
            # what rank d - 1 produced at tick t reaches rank d at tick t + 1
            recvs = ([(pr.peers[d - 1], tuple(micro.shape[1:]), x.dtype, _FWD)]
                     if d > 0 and 0 <= t + 1 - d < n_micro else [])
            got = pr.transport.exchange(sends, recvs, pooled=True)
            inflight = got[0] if recvs else None
    out = (torch.cat(outputs, dim=0) if d == s - 1
           else torch.empty(x.shape, dtype=x.dtype, device=dev))
    return pr.transport.broadcast(out, pr.peers[s - 1]).to(x.device)


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
    ticks (and between phase segments).  Per-rank entries are keyed by
    pipeline rank: every rank in the single controller, this process's own
    in the process mode."""

    slots: dict           # per rank: (slot row, its leaves on the rank's device)
    micro: torch.Tensor   # (M, micro batch, ...) inputs
    tmicro: torch.Tensor  # (M, micro batch, ...) targets
    gacc: list            # per-slot gradient accumulators, flat like stage_params
    first: Any            # first_params' leaves on rank 0's device (hooks)
    last: Any             # last_params' leaves on the last rank's device (hooks)
    facc: list            # first_params' gradient accumulators
    lacc: list            # last_params' gradient accumulators
    stash: dict           # per rank: ring of (stage input, loss seed) by slot
    loss: torch.Tensor    # f32, on the last rank's device
    recv_f: list          # activation each rank receives at this tick
    recv_b: list          # activation gradient each rank receives
    stash_peak: int = 0   # most stage inputs one rank held at once


def _check_stage_spec(stage_spec: Any, axis: str) -> Any:
    """``stage_spec`` (``P(axis)`` when None) after checking every leaf's
    entries: the slot dimension on ``axis``, nothing else sharded."""
    if stage_spec is None:
        return PartitionSpec(axis)
    for spec in tree_leaves(stage_spec):
        entries = tuple(spec)
        if not entries or entries[0] != axis:
            raise ValueError(f"stage_spec leaf {spec!r}: the leading (slot) entry must be "
                             f"the pipeline axis {axis!r}")
        if any(e is not None for e in entries[1:]):
            raise NotImplementedError(
                f"stage_spec leaf {spec!r} shards a stage parameter over an inner mesh "
                f"axis: the stage body computes on whole stage parameters, and the "
                f"reference's stage body is not collective-aware either "
                f"(src/repro/models/pipeline.py stage_param_specs); pipeline over a "
                f"pod-only mesh, where every inner entry drops")
    return stage_spec


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

    On a ``DeviceMesh`` (the process mode, module docstring) each process
    passes only its own rank's slots (any number; ``stage_mask`` covers
    those), every rank passes the same ``x`` and ``targets``,
    ``first_params`` is needed on rank 0 only and ``last_params`` on the
    last rank only, and the result is this rank's: its slots' gradients,
    ``first_grads`` on rank 0 and ``last_grads`` on the last rank (``None``
    elsewhere), and the loss on every rank (the last rank broadcasts it).

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
        The pipeline mesh axis: a :class:`Mesh` (the single controller; the
        slot count must be a multiple of the axis size and each rank runs a
        contiguous slot block) or a 1-d ``DeviceMesh`` named ``(axis,)``
        (the process mode).
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
        scope times the phase's device work, not just its dispatch.  In the
        process mode the ranks meet at a barrier before each segment.
    stage_spec:
        ``PartitionSpec`` tree (``models.pipeline.stage_param_specs``) of the
        packed stage parameters: every leaf's leading entry must be the
        pipeline ``axis``.  Defaults to ``P(axis)`` (stage-sharded, otherwise
        replicated).  A spec whose trailing entries shard a parameter over
        the mesh's inner axes raises ``NotImplementedError``: the stage body
        computes on whole stage parameters, and the reference's is not
        collective-aware either.
    activation_spec:
        Process mode with ``first_fn``: ``activation_spec(raw_microbatch) ->
        (shape, dtype)`` of the activation ``first_fn`` makes of it, which
        ranks past the first receive (without hooks: the raw microbatch's
        own).
    """

    def __init__(
        self,
        layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None,
        *,
        mesh: Any,
        axis: str,
        n_micro: int,
        first_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
        last_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
        phase_cb: Callable[[str], object] | None = None,
        stage_spec: Any | None = None,
        activation_spec: Callable[[torch.Tensor], tuple] | None = None,
    ) -> None:
        if (first_fn is None) != (last_fn is None):
            raise ValueError(
                "first_fn and last_fn pin the pipeline's heterogeneous ends "
                "together: pass both or neither"
            )
        if loss_fn is None and last_fn is None:
            raise ValueError("loss_fn may only be None when last_fn is given")
        self.stage_spec = _check_stage_spec(stage_spec, axis)
        self.layer_fn = layer_fn
        self.loss_fn = loss_fn
        self.first_fn = first_fn
        self.last_fn = last_fn
        self.mesh = mesh
        self.axis = axis
        self.n_micro = int(n_micro)
        self.phase_cb = phase_cb
        self.activation_spec = activation_spec
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        #: the process mode's place on the axis (None: the single controller)
        self.procs = _procs(mesh, axis) if is_process_mesh(mesh) else None
        if self.procs is not None:
            if first_fn is not None and activation_spec is None and self.procs.size > 1:
                raise ValueError("the process mode with first_fn needs activation_spec: "
                                 "ranks past the first receive first_fn's activations")
            self.axis_size = self.procs.size
            self.devices = None
            # the first torch.autograd.grad of a process imports torch.fx's
            # symbolic shapes (sympy: seconds); imported here, every rank
            # pays it at once, not one rank after another along the first
            # step's backward ticks
            import torch.fx.experimental.symbolic_shapes  # noqa: F401
        else:
            self.axis_size = int(mesh.shape[axis])
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
        pr = self.procs
        own = range(s) if pr is None else [pr.rank]
        has_first = hooks and 0 in own
        has_last = hooks and s - 1 in own
        if (has_first and first_params is None) or (has_last and last_params is None):
            raise ValueError(
                "first_params/last_params are required when first_fn/last_fn "
                "are set" + ("" if pr is None else " (on the first and last rank)")
            )
        if not hooks and (first_params is not None or last_params is not None):
            raise ValueError(
                "first_params/last_params given but the step has no "
                "first_fn/last_fn"
            )
        leaves = tree_leaves(stage_params)
        if not leaves and pr is None:
            raise ValueError("stage_params has no array leaves")
        n_slots = int(leaves[0].shape[0]) if leaves else 0
        for leaf in leaves:
            if int(leaf.shape[0]) != n_slots:
                raise ValueError(
                    f"stage_params leaves disagree on the slot dimension: "
                    f"{leaf.shape[0]} != {n_slots}"
                )
        if pr is None and n_slots % s != 0:
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

        r = min(2 * s, m)
        zeros = lambda tree: [torch.zeros_like(leaf) for leaf in tree_leaves(tree)]  # noqa: E731
        if pr is None:
            per_rank = n_slots // s
            blocks = {d: (dev, range(d * per_rank, (d + 1) * per_rank))
                      for d, dev in enumerate(self.devices)}
        else:
            blocks = {pr.rank: (pr.device, range(n_slots))}
        c = _Call(
            # each rank's active slots, as leaves on its device; padded
            # slots are never touched (no launch, zero gradient)
            slots={d: [(i, _on(tree_map(lambda leaf, i=i: leaf[i], stage_params), dev))
                       for i in rows if active[i]]
                   for d, (dev, rows) in blocks.items()},
            micro=x.reshape((m, batch // m) + tuple(x.shape[1:])),
            tmicro=targets.reshape((m, batch // m) + tuple(targets.shape[1:])),
            gacc=zeros(stage_params),
            first=_on(first_params, self._device(0)) if has_first else None,
            last=_on(last_params, self._device(s - 1)) if has_last else None,
            facc=zeros(first_params) if has_first else [],
            lacc=zeros(last_params) if has_last else [],
            stash={d: [None] * r for d in blocks},
            loss=torch.zeros((), dtype=torch.float32, device=self._device(s - 1)),
            recv_f=[None] * s, recv_b=[None] * s,
        )
        run = self._run if pr is None else self._run_rank
        if self.phase_cb is None:
            run(c, 0, m + 2 * s - 1)
        else:
            for name, (t0, t1) in phase_ticks(m, s).items():
                if t1 <= t0:
                    continue
                if pr is not None:  # every rank enters the segment together
                    self._barrier()
                with self.phase_cb(name):
                    run(c, t0, t1)
                    # inside the scope: the caliper window covers the
                    # phase's device work, not just its dispatch
                    self._sync()
        self.last_stash_peak = c.stash_peak
        loss = c.loss if pr is None else pr.transport.broadcast(c.loss, pr.peers[s - 1])
        it = iter(c.gacc)
        grads = tree_map(lambda _: next(it), stage_params)
        if not hooks:
            return loss, grads
        it_f, it_l = iter(c.facc), iter(c.lacc)
        return loss, (grads,
                      tree_map(lambda _: next(it_f), first_params) if has_first else None,
                      tree_map(lambda _: next(it_l), last_params) if has_last else None)

    # -- the schedule ---------------------------------------------------------
    def _device(self, d: int) -> torch.device:
        """Rank ``d``'s device (this process's own in the process mode)."""
        return self.devices[d] if self.procs is None else self.procs.device

    def _sync(self) -> None:
        devices = [self.procs.device] if self.procs is not None else self.devices
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def _barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.procs.group)

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

    def _tick(self, c: _Call, d: int, t: int):
        """Rank ``d``'s half of tick ``t``: its forward, then its backward.
        Returns ``(forward output, activation gradient)``, each ``None``
        where the rank ran none (the ring sends them on)."""
        s, m = self.axis_size, self.n_micro
        r = min(2 * s, m)
        hooks = self.last_fn is not None
        last = s - 1
        dev = self._device(d)
        y = dact = None
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
        return y, dact

    def _run(self, c: _Call, t0: int, t1: int) -> None:
        s = self.axis_size
        for t in range(t0, t1):
            sent = [self._tick(c, d, t) for d in range(s)]
            # the rings: rank d's output reaches rank d + 1, its activation
            # gradient rank d - 1, at tick t + 1 (rank 0 feeds from the input
            # and the last rank from its seed, so the wrap-around is not sent)
            c.recv_f = [None] + [
                None if sent[d - 1][0] is None else sent[d - 1][0].to(self.devices[d])
                for d in range(1, s)
            ]
            c.recv_b = [
                None if sent[d + 1][1] is None else sent[d + 1][1].to(self.devices[d])
                for d in range(s - 1)
            ] + [None]

    def _run_rank(self, c: _Call, t0: int, t1: int) -> None:
        """The process mode: this rank's half of ticks ``[t0, t1)``, each
        ending with one batch of the tick's ring messages."""
        pr = self.procs
        s, m, d = self.axis_size, self.n_micro, pr.rank
        spec = None
        for t in range(t0, t1):
            y, dact = self._tick(c, d, t)
            sends = []
            if y is not None and d < s - 1:
                sends.append((pr.peers[d + 1], y, _FWD))
            if dact is not None and d > 0:
                sends.append((pr.peers[d - 1], dact, _BWD))
            # what comes at tick t + 1, from the tick formulas alone: rank
            # d - 1's forward of microbatch t + 1 - d, rank d + 1's backward
            # of microbatch t + 1 - (2S - 1 - d); activations and their
            # gradients share one shape and dtype
            recv_f = d > 0 and 0 <= t + 1 - d < m
            recv_b = d < s - 1 and 0 <= t + 1 - (2 * s - 1 - d) < m
            if (recv_f or recv_b) and spec is None:
                spec = self._activation(c)
            recvs = ([(pr.peers[d - 1], *spec, _FWD)] if recv_f else []) + \
                    ([(pr.peers[d + 1], *spec, _BWD)] if recv_b else [])
            got = iter(pr.transport.exchange(sends, recvs, pooled=True))
            c.recv_f[d] = next(got) if recv_f else None
            c.recv_b[d] = next(got) if recv_b else None

    def _activation(self, c: _Call) -> tuple[tuple, torch.dtype]:
        """(shape, dtype) of a stage activation (and of its gradient)."""
        if self.first_fn is not None:
            shape, dtype = self.activation_spec(c.micro[0])
            return tuple(shape), dtype
        return tuple(c.micro.shape[1:]), c.micro.dtype

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
