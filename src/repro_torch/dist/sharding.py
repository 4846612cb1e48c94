"""Logical-axis sharding: named tensor axes -> physical mesh axes.

Model code never mentions physical mesh axes.  Parameters and activations are
annotated with *logical* axis names (``"embed"``, ``"heads"``, ``"batch"`` ...)
and a :class:`ShardingRules` table maps each logical axis to zero or more mesh
axes.  :func:`spec_for` resolves one tensor's annotation into a
:class:`PartitionSpec` with three safety semantics (the reference's):

* **absent-axis drop** — a rule naming a mesh axis the current mesh does not
  have is silently skipped, so the same rule table serves the 512-chip
  multi-pod mesh and a 1-process smoke run;
* **divisibility drop** — a mesh axis whose size does not divide the tensor
  dimension is skipped (every shard is then equal, as ``DTensor.from_local``
  assumes);
* **once-per-tensor** — a mesh axis may shard at most one dimension of a given
  tensor; later uses are dropped.

Trailing ``None`` entries are trimmed so specs compare cleanly
(``P("data")``, not ``P("data", None)``).

:func:`placements_for` turns a spec into the ``DTensor`` placements of a
``DeviceMesh``: one ``Shard(dim)`` or ``Replicate()`` per mesh dimension.
``spec_for`` reads only the mesh's ``.shape`` as a dict of axis sizes (the
port's :class:`~repro_torch.dist.meshutil.Mesh`, or any object with such a
``.shape``) or a ``DeviceMesh``'s ``mesh_dim_names`` and ``.shape``.
:func:`distribute_tree` lays a tree of full tensors, the same on every rank,
out as DTensors, each rank keeping its own shards without moving a byte;
:func:`gather_tree` is the way back (a collective).
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping, Sequence
from typing import Any

__all__ = [
    "Axes",
    "PartitionSpec",
    "ShardingRules",
    "DEFAULT_RULES",
    "FSDP_RULES",
    "spec_for",
    "placements_for",
    "tree_shardings",
    "local_shard",
    "distribute_tree",
    "gather_tree",
    "mesh_sizes",
]

AxisAssignment = str | Sequence[str] | None


class Axes(tuple):
    """Logical-axis annotation for one tensor (e.g. ``Axes(("embed", "heads"))``).

    A ``tuple`` subclass so it behaves like the axis tuple everywhere, but —
    unlike a plain tuple — the port's tree walker (``models.layers.tree_map``)
    treats it as a *leaf*, which lets whole-tree operations
    (:func:`tree_shardings`) map an axes tree against a matching shape tree.
    """

    __slots__ = ()
    #: read by ``models.layers.tree_map``: this tuple is a leaf, not a node
    tree_leaf = True

    def __new__(cls, axes: Iterable[str | None] = ()) -> Axes:
        return tuple.__new__(cls, tuple(axes))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Axes{tuple.__repr__(self)}"


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of mesh axes (sharded over their product, major axis
    first) — the port's counterpart of ``jax.sharding.PartitionSpec``."""

    __slots__ = ()
    tree_leaf = True

    def __new__(cls, *entries: Any) -> PartitionSpec:
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"P{tuple.__repr__(self)}"


def _normalize(assignment: AxisAssignment) -> tuple[str, ...]:
    if assignment is None:
        return ()
    if isinstance(assignment, str):
        return (assignment,)
    return tuple(assignment)


class ShardingRules:
    """Immutable table mapping logical axis names to mesh-axis assignments.

    Values may be ``None`` (replicate), one mesh axis name, or a sequence of
    mesh axes (the dimension is sharded over their product, e.g. ``"batch"``
    over ``("pod", "data")``).  Unknown logical axes resolve to ``()``.
    """

    __slots__ = ("_table",)

    def __init__(self, table: Mapping[str, AxisAssignment]) -> None:
        object.__setattr__(
            self, "_table", {k: _normalize(v) for k, v in table.items()}
        )

    def get(self, logical: str) -> tuple[str, ...]:
        """Mesh axes assigned to ``logical`` (``()`` if unmapped)."""
        return self._table.get(logical, ())

    def items(self):
        return self._table.items()

    def with_overrides(self, **overrides: AxisAssignment) -> ShardingRules:
        """A new table with some assignments replaced; ``self`` is untouched."""
        table: dict[str, AxisAssignment] = dict(self._table)
        table.update(overrides)
        return ShardingRules(table)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ShardingRules) and self._table == other._table

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._table.items())))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ShardingRules({self._table!r})"


#: Tensor-parallel default: contraction-heavy axes over "model", the global
#: batch over ("pod", "data"); everything else replicated.
DEFAULT_RULES = ShardingRules(
    {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "ffn": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "layers": (),
        "conv": (),
    }
)

#: tp+fsdp preset: like DEFAULT but parameters' "embed" dimension is sharded
#: over the data axis (ZeRO-3-style weight sharding; optimizer state inherits
#: it through ``opt_state_axes``).
FSDP_RULES = DEFAULT_RULES.with_overrides(embed=("data",))


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``) or of
    any mesh whose ``.shape`` is such a dict (the port's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def spec_for(
    axes: Sequence[str | None],
    shape: Sequence[int],
    mesh: Any,
    rules: ShardingRules,
) -> PartitionSpec:
    """Resolve one tensor's logical axes into a :class:`PartitionSpec`.

    ``axes`` and ``shape`` must have equal rank; ``None`` entries replicate
    that dimension.  See the module docstring for the drop semantics.
    """
    axes = tuple(axes)
    shape = tuple(shape)
    if len(axes) != len(shape):
        raise ValueError(
            f"rank mismatch: axes {axes} (rank {len(axes)}) vs shape {shape} "
            f"(rank {len(shape)})"
        )
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: list = []
    for logical, dim in zip(axes, shape):
        assigned: list = []
        if logical is not None:
            factor = 1
            for mesh_axis in rules.get(logical):
                if mesh_axis not in sizes or mesh_axis in used:
                    continue
                grown = factor * sizes[mesh_axis]
                if dim % grown != 0:
                    continue
                factor = grown
                assigned.append(mesh_axis)
                used.add(mesh_axis)
        if not assigned:
            entries.append(None)
        elif len(assigned) == 1:
            entries.append(assigned[0])
        else:
            entries.append(tuple(assigned))
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(spec: Sequence, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension in
    mesh order, ``Shard(d)`` where tensor dimension ``d`` names that axis,
    else ``Replicate()``.  A dimension sharded over several axes (``batch``
    over ``("pod", "data")``) gives one ``Shard(d)`` per axis; in mesh order
    the major axis comes first, so the shards are laid out as JAX lays them
    out when the spec lists its axes in mesh order, as ``spec_for`` does
    under the rule tables here.  A mesh dimension of one rank splits
    nothing and stays ``Replicate()`` (DTensor would refuse to merge a
    dimension sharded over it into another in a view)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else tuple(entry):
            if axis not in names:
                raise ValueError(f"spec {tuple(spec)} names {axis!r}, not an axis of "
                                 f"the mesh {names}")
            if sizes[axis] > 1:
                placements[names.index(axis)] = Shard(dim)
    return tuple(placements)


def tree_shardings(axes_tree, shape_tree, mesh: Any, rules: ShardingRules):
    """Map an :class:`Axes` tree against a matching tree of shapes into
    :class:`PartitionSpec`s.  ``shape_tree`` leaves need only a ``.shape``
    (tensors, ``PSpec``s); empty subtrees (``()``/``{}``) pass through."""
    from ..models.layers import tree_map

    return tree_map(lambda ax, leaf: spec_for(tuple(ax), tuple(leaf.shape), mesh, rules),
                    axes_tree, shape_tree)


def local_shard(x, mesh: Any, placements: Sequence):
    """This rank's shard of the full tensor ``x`` under ``placements``: the
    chunk of each sharded dimension at this rank's coordinate, mesh
    dimensions in order (so the major axis splits first), copied out so the
    full tensor can be freed."""
    from torch.distributed.tensor import Shard

    out = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out = out.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return out.clone() if out is not x else out


def distribute_tree(tree, axes_tree, mesh: Any, rules: ShardingRules, device=None):
    """DTensors of a tree of full tensors that every rank holds alike (made
    from one seed, or loaded from one checkpoint): each leaf laid out by its
    logical axes, every rank keeping its own shards of its own copy
    (:func:`local_shard`), so no collective runs.  ``device`` moves each
    shard there (a tree loaded on the host, sharded before it reaches the
    card)."""
    from torch.distributed.tensor import DTensor

    from ..models.layers import tree_map

    def one(x, ax):
        placements = placements_for(spec_for(tuple(ax), tuple(x.shape), mesh, rules), mesh)
        shard = local_shard(x, mesh, placements)
        if device is not None:
            shard = shard.to(device)
        return DTensor.from_local(shard, mesh, placements, run_check=False)

    return tree_map(one, tree, axes_tree)


def gather_tree(tree):
    """Full plain tensors of a tree of DTensors, on every rank (one
    all-gather a sharded leaf); plain leaves pass through."""
    from ..models.layers import tree_map
    from .context import is_dtensor

    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)
