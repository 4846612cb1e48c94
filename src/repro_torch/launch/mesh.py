"""Production mesh construction (the multi-pod dry run's spec): the port's
counterpart of ``src/repro/launch/mesh.py``.

A FUNCTION, not a module-level constant, so importing this module touches
no process group.  Single pod: 16x16 = 256 ranks, ("data", "model").
Multi-pod: 2x16x16 = 512 ranks, ("pod", "data", "model") — the leading
"pod" axis maps to the slower inter-pod links; batch is sharded over
("pod", "data") and cross-pod traffic is gradient reduction only
(optionally int8-compressed, ``optim/compression.py``).

``make_production_mesh`` builds a ``DeviceMesh`` over the current default
process group, which must hold the mesh's ranks.  The dry run
(``launch.dryrun``) has no such cluster: :func:`start_fake_group` starts a
``fake`` process group of any world size in this one process (rank 0; its
collectives return at once, moving nothing), as the reference's dry run
compiles against 512 placeholder host devices.
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "start_fake_group", "POD_SHAPE", "MULTI_POD_SHAPE"]

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production ``DeviceMesh`` on ``device`` over the current process
    group, whose world size must be 256 (or 512 with ``multi_pod``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a process group of "
                           f"{math.prod(shape)} ranks, not {have} (start_fake_group for a "
                           f"dry run)")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def start_fake_group(world_size: int) -> None:
    """Make a ``fake`` process group of ``world_size`` ranks, this process
    being rank 0, the default group; a fake group of another size is
    replaced, one of this size kept.  A real group raises: the dry run never
    replaces a group that moves data."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; the dry run "
                               f"starts its own fake group in a process without one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
