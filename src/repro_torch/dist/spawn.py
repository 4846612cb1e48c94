"""Run a function on every rank of a fresh process group.

``run_ranks(fn, world, *args)`` spawns ``world`` processes; each joins a
default process group through a ``file://`` rendezvous in a temporary
directory of its own (no port to pick, so concurrent callers never collide)
and runs ``fn(rank, world, *args)``.  Ranks on ``"cuda"`` take card
``rank % device_count`` and share it when there are fewer cards than ranks
(gloo; NCCL with a card a rank: ``meshutil.init_process_group``).  The
return values come back in rank order.  A rank that raises or dies fails
the call with that rank's error, and the other ranks are stopped: no rank's
failure is swallowed.
"""

from __future__ import annotations

import os
import tempfile
import traceback
from collections.abc import Callable
from typing import Any

import torch

__all__ = ["run_ranks"]


def _rank_main(rank: int, fn: Callable[..., Any], world: int, init: str, device: str,
               out_dir: str, args: tuple) -> None:
    import torch.distributed as dist

    from .meshutil import init_process_group

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_process_group(device, init_method=init, rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, *args: Any, device: str = "cpu") -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each on its own
    process in one process group.  ``fn`` and ``args`` must pickle (a
    module-level function); results travel back through ``torch.save``.
    Raises ``RuntimeError`` holding every failed rank's traceback."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        try:
            mp.start_processes(_rank_main, args=(fn, world, init, device, tmp, args),
                               nprocs=world, join=True, start_method="spawn")
        except Exception as exc:
            # every rank's own error, not only the first one the join saw
            # (often a peer's broken connection)
            errors = [f"-- rank {r}:\n" + open(os.path.join(tmp, f"rank{r}.err")).read()
                      for r in range(world) if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
            raise RuntimeError(f"{len(errors)} of {world} ranks failed\n" + "\n".join(errors)
                               ) from exc
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
