"""Ambient sharding context: annotate tensors without threading (mesh, rules).

``use_sharding(mesh, rules)`` installs a thread-local (mesh, rules) pair for
the duration of a step; ``constrain(x, *logical_axes)`` then resolves the
logical annotation against the ambient context and, for a ``DTensor``,
redistributes it to the placements the annotation resolves to (the port's
counterpart of ``jax.lax.with_sharding_constraint``).  Outside any context,
and for a plain tensor, ``constrain`` is a no-op, so model code carries its
sharding annotations unconditionally and every unsharded path stays as it
was, bit for bit.

Under a ``DeviceMesh`` the context also turns on DTensor's implicit
replication, so the plain tensors model code makes (rotary tables, masks,
zero aux losses) combine with sharded activations as replicated values.

``local_apply`` is the kernel boundary: a hand-written kernel takes plain
tensors, so a ``DTensor`` is redistributed to the placements the kernel can
run on shard by shard, handed over as its local shard, and the result is
wrapped back into a ``DTensor``; autograd runs through both conversions.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections.abc import Callable, Iterator, Sequence
from typing import Any

import torch

from .sharding import ShardingRules, placements_for, spec_for

__all__ = ["use_sharding", "current_sharding", "constrain", "gather_fsdp", "is_dtensor",
           "local_apply", "local_rows", "placements_of", "shard_of"]

_STATE = threading.local()


def _dtensor_type():
    """DTensor's class once its module is loaded; None before that, when no
    tensor can be a DTensor (so a process that never shards does not pay
    the seconds that importing DTensor costs)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)


def is_dtensor(x: Any) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``."""
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


def _is_device_mesh(mesh: Any) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


@contextlib.contextmanager
def use_sharding(mesh: Any, rules: ShardingRules) -> Iterator[None]:
    """Make (mesh, rules) the ambient sharding context; nestable.  With a
    ``DeviceMesh``, plain tensors that meet DTensors inside it count as
    replicated."""
    previous = getattr(_STATE, "context", None)
    _STATE.context = (mesh, rules)
    try:
        if _is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _STATE.context = previous


def current_sharding() -> tuple[Any, ShardingRules] | None:
    """The active (mesh, rules) pair, or ``None`` outside ``use_sharding``."""
    return getattr(_STATE, "context", None)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Constrain ``x`` to the sharding its logical axes resolve to.

    One ``logical_axes`` entry per dimension of ``x`` (``None`` = replicated
    dimension).  A no-op when no sharding context is active or ``x`` is a
    plain tensor; a ``Partial`` DTensor is reduced on the way.
    """
    context = current_sharding()
    if context is None or not is_dtensor(x):
        return x
    mesh, rules = context
    placements = placements_for(spec_for(logical_axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_fsdp(tree):
    """``tree`` with every DTensor gathered over the mesh axes the ambient
    rules give ``"embed"`` (FSDP: ``FSDP_RULES`` shards the parameters'
    width over "data"), as ZeRO-3 gathers a parameter for compute.  The
    gather is differentiable: the gradient comes back reduce-scattered to
    the stored shards.  A no-op outside a context, for plain tensors, and
    under rules that leave "embed" whole."""
    context = current_sharding()
    if context is None:
        return tree
    mesh, rules = context
    axes = set(rules.get("embed"))
    names = getattr(mesh, "mesh_dim_names", None)
    if not axes or names is None:
        return tree
    from torch.distributed.tensor import Replicate

    from ..models.layers import tree_map

    def one(x):
        if not is_dtensor(x):
            return x
        placements = tuple(Replicate() if names[i] in axes else p
                           for i, p in enumerate(x.placements))
        return x if placements == tuple(x.placements) else x.redistribute(mesh, placements)

    return tree_map(one, tree)


def placements_of(x: torch.Tensor, *, replicate_dims: Sequence[int] = ()) -> tuple:
    """``x``'s placements with every ``Partial`` reduced and every shard of a
    tensor dimension in ``replicate_dims`` (negative counts from the end)
    gathered: where a kernel that works along those dimensions can run on
    ``x`` shard by shard."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in replicate_dims}
    out = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim % x.ndim not in dims:
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out)


def shard_of(x: torch.Tensor, dim: int, placements: Sequence | None = None) -> tuple[int, int]:
    """(ranks, this rank's index among them) over the mesh dimensions whose
    placement in ``placements`` (``x``'s own by default) shards tensor
    dimension ``dim`` of DTensor ``x``, the major mesh dimension first."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    n, idx = 1, 0
    for i, p in enumerate(placements if placements is not None else x.placements):
        if p == Shard(dim):
            n *= mesh.size(i)
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return n, idx


def local_apply(
    fn: Callable[..., Any],
    inputs: Sequence[tuple[torch.Tensor, tuple, tuple | None]],
    out_placements: Sequence[tuple],
    *,
    mesh: Any,
):
    """Run ``fn`` on the local shards of DTensor ``inputs`` and wrap its
    outputs as DTensors on ``mesh``.

    Each input is ``(x, placements, grad_placements)``: ``x`` (a DTensor, or
    a plain tensor taken as replicated) is redistributed to ``placements``
    and handed to ``fn`` as its local shard; ``grad_placements`` (None: the
    same) says how the gradient of that local shard adds up across ranks —
    ``Partial()`` on a mesh dimension where each rank's gradient is its own
    part of the sum (a replicated weight applied to batch shards).  Output
    ``i`` of ``fn`` is this rank's shard under ``out_placements[i]``; every
    shard is even, as ``spec_for``'s divisibility drop makes them.
    """
    from torch.distributed.tensor import DTensor, Replicate

    local = []
    for x, placements, grad_placements in inputs:
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(mesh, placements)
        local.append(x.to_local(grad_placements=grad_placements))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(DTensor.from_local(o, mesh, p, run_check=False)
                    for o, p in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


def local_rows(fn: Callable[..., Any], x: torch.Tensor, weight: torch.Tensor):
    """``fn(x, weight)`` of a DTensor ``x`` normalized along its last
    dimension, on each rank's local rows: ``x`` keeps its shards except
    along that width (gathered, a ``Partial`` reduced), the weight is
    replicated (an FSDP-sharded one gathered), and the weight's gradient is
    each rank's part of the sum over the rows wherever ``x`` is sharded.
    The output has ``x``'s placements, so its gradient is reduced before
    ``fn``'s backward runs."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = placements_of(x, replicate_dims=(-1,))
    w_pl = (Replicate(),) * len(x_pl)
    w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x_pl)
    return local_apply(fn, [(x, x_pl, None), (weight, w_pl, w_grad)], [x_pl], mesh=x.device_mesh)
