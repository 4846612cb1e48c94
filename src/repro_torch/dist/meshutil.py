"""Local mesh construction for launchers, tests, and CI.

A :class:`Mesh` is an array of ``torch.device`` with one name per axis: the
port's counterpart of ``jax.sharding.Mesh`` for the single-controller
pipeline, where pipeline rank ``d`` computes on the device at index ``d`` of
the pipeline axis.  ``local_mesh`` builds one from a settings-style
``mesh_shape`` over this process's cards, with clear errors when the
requested shape cannot be satisfied; ``device="cpu"`` builds any shape, its
ranks sharing the host (the counterpart of the reference's
``--xla_force_host_platform_device_count``).  ``remove_host`` is the
eviction rebuild: the same mesh minus one slice along an axis, used by the
straggler-response controller when a host is pulled from the fleet.

Only a :class:`Mesh` built explicitly may repeat a device (several ranks
sharing one card); ``local_mesh`` never does so on ``"cuda"``.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch

__all__ = ["Mesh", "local_mesh", "default_axis_names", "pipeline_submeshes", "remove_host"]

_AXIS_NAMES_BY_RANK = {
    1: ("data",),
    2: ("data", "model"),
    3: ("pod", "data", "model"),
}


class Mesh:
    """An n-d array of ``torch.device`` and a name for each axis."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        self.devices = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"axis_names {self.axis_names} do not match a {self.devices.ndim}-d "
                f"device array of shape {self.devices.shape}"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis_names {self.axis_names} repeat a name")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_axis_names(rank: int) -> tuple[str, ...]:
    """Conventional axis names for a mesh of the given rank."""
    if rank not in _AXIS_NAMES_BY_RANK:
        raise ValueError(
            f"no default axis names for a rank-{rank} mesh; pass axis_names "
            f"explicitly (defaults exist for ranks {sorted(_AXIS_NAMES_BY_RANK)})"
        )
    return _AXIS_NAMES_BY_RANK[rank]


def local_mesh(
    mesh_shape: Sequence[int] = (1, 1),
    axis_names: Sequence[str] | None = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """Build a mesh of ``mesh_shape`` from this process's devices.

    ``device="cuda"`` uses the first ``prod(mesh_shape)`` cards, one per
    position, so a smaller mesh than the card count is allowed and a larger
    one raises.  ``device="cpu"`` places every position on the host: the
    same launcher code path runs in CI at any shape.
    """
    shape = tuple(int(s) for s in mesh_shape)
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"mesh_shape must be non-empty positive ints, got {mesh_shape!r}")
    names = tuple(axis_names) if axis_names is not None else default_axis_names(len(shape))
    if len(names) != len(shape):
        raise ValueError(f"axis_names {names} does not match mesh_shape {shape}")
    n_needed = math.prod(shape)
    kind = torch.device(device).type
    if kind == "cpu":
        devices = [torch.device("cpu")] * n_needed
    elif kind == "cuda":
        visible = torch.cuda.device_count()
        if n_needed > visible:
            raise ValueError(
                f"mesh_shape {shape} needs {n_needed} devices but only {visible} are "
                f"visible; pass device='cpu' for CPU dry-runs, or build a Mesh that "
                f"repeats a card explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(n_needed)]
    else:
        raise ValueError(f"local_mesh places ranks on 'cuda' or 'cpu', got {device!r}")
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), names)


def remove_host(mesh: Mesh, index: int, axis: str | None = None) -> Mesh:
    """Rebuild ``mesh`` without slice ``index`` along ``axis`` — the straggler
    eviction path.

    Surviving devices keep their relative order; only the named axis loses
    one slice.  ``axis`` defaults to the mesh's first (host/data) axis.  A
    size-1 axis refuses the removal: a fleet cannot evict its last slice.
    """
    names = tuple(mesh.axis_names)
    axis = axis if axis is not None else names[0]
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; axes are {names}")
    pos = names.index(axis)
    size = int(mesh.shape[axis])
    if size < 2:
        raise ValueError(
            f"cannot remove slice {index} from axis {axis!r} of size {size}: "
            f"a mesh cannot lose its last slice"
        )
    if not 0 <= index < size:
        raise ValueError(f"slice {index} out of range [0, {size}) on axis {axis!r}")
    return Mesh(np.delete(mesh.devices, index, axis=pos), names)


def pipeline_submeshes(mesh: Mesh, axis: str) -> list[Mesh]:
    """One mesh per slice along ``axis``, spanning the remaining axes.

    Slice ``i`` of the returned list holds the devices of pipeline rank
    ``i``; each submesh keeps the remaining axis names and device order.  A
    rank-1 mesh yields single-device ``(1,)`` submeshes (the axis name is
    retained with size 1).
    """
    names = tuple(mesh.axis_names)
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; axes are {names}")
    pos = names.index(axis)
    out: list[Mesh] = []
    for i in range(int(mesh.shape[axis])):
        stage_devices = np.take(mesh.devices, [i], axis=pos)
        if len(names) > 1:
            stage_devices = np.squeeze(stage_devices, axis=pos)
            out.append(Mesh(stage_devices, names[:pos] + names[pos + 1:]))
        else:
            out.append(Mesh(stage_devices, names))
    return out
