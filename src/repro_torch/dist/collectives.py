"""The collectives of a DeviceMesh whose ranks talk over gloo: routed,
counted and timed.

DTensor moves data with PyTorch's functional collectives (the
``_c10d_functional`` operators).  On a card that several ranks share, NCCL
refuses the ranks ("Duplicate GPU detected"), so they talk over gloo, which
carries CUDA tensors by staging them through host memory.  Under torch 2.11
(cu128, one H100) DTensor's all-gather (``_c10d_functional.
all_gather_into_tensor``) killed the rank with SIGSEGV on CUDA tensors over
gloo, while the process group's own ``all_gather_into_tensor`` on the same
tensors was right (``tools/probe_collectives.py``); all-reduce,
reduce-scatter, broadcast and all-to-all were right both ways.

:func:`route_collectives` therefore registers, for one device type, kernels
of the five functional collectives DTensor calls that run the process
group's own collective on the given tensors and wait for it: the same
collective the native kernel would run, with nothing moved off the device
by the port (gloo stages CUDA payloads through host memory itself).  Each
call adds one to :data:`COUNTS` and its bytes to :data:`BYTES`, and runs
inside the timer ``dist/collective/<name>`` (``repro_torch.timing``); on
CUDA the stream is synchronized before the timer starts and before it
stops, so the timer holds the collective alone, not the kernels queued
before it.  Meshes on NCCL (a card per rank) are not routed.  DTensor
broadcasts (``distribute_tensor``) and, under torch 2.11, moves a shard
between dimensions without these operators; those calls are neither routed
nor counted (phase 28 of ``chip_smoke.py`` prints which were).
"""

from __future__ import annotations

import warnings

import torch

__all__ = ["COLLECTIVES", "COUNTS", "BYTES", "route_collectives", "collective_seconds"]

#: the functional collectives DTensor calls, by the name they are counted under
COLLECTIVES = {
    "all_reduce": "all_reduce",
    "all_gather": "all_gather_into_tensor",
    "reduce_scatter": "reduce_scatter_tensor",
    "all_to_all": "all_to_all_single",
    "broadcast": "broadcast",
}
#: routed calls in this process, by collective
COUNTS = dict.fromkeys(COLLECTIVES, 0)
#: bytes of the routed calls' inputs in this process, by collective
BYTES = dict.fromkeys(COLLECTIVES, 0)
#: the device types routed in this process, with the library that holds the kernels
_LIBRARIES: dict[str, object] = {}


def collective_seconds(db=None) -> dict[str, float]:
    """Seconds in each routed collective's timer so far (0 where it never ran)."""
    from ..core.timers import timer_db

    db = db if db is not None else timer_db()
    return {name: db.get(f"dist/collective/{name}").seconds() if db.exists(
        f"dist/collective/{name}") else 0.0 for name in COLLECTIVES}


def _op(name: str):
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    if name.lower() not in ops:
        raise NotImplementedError(f"routed collectives reduce with {sorted(ops)}, not {name!r}")
    return ops[name.lower()]


def _group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


def _run(name: str, payload: torch.Tensor, fn):
    """Run ``fn()`` (which waits for its work) inside the collective's timer."""
    from ..timing import scope_handle

    cuda = payload.device.type == "cuda"
    if cuda:
        torch.cuda.current_stream(payload.device).synchronize()
    with scope_handle(f"dist/collective/{name}"):
        out = fn()
        if cuda:
            torch.cuda.current_stream(payload.device).synchronize()
    COUNTS[name] += 1
    BYTES[name] += payload.numel() * payload.element_size()
    return out


def _all_reduce(inp, reduce_op, group_name):
    import torch.distributed as dist

    pg = _group(group_name)

    def go():
        out = inp.clone(memory_format=torch.contiguous_format)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _op(reduce_op)
        pg.allreduce([out], opts).wait()
        return out.div_(pg.size()) if reduce_op.lower() == "avg" else out

    return _run("all_reduce", inp, go)


def _all_gather(inp, group_size, group_name):
    pg = _group(group_name)

    def go():
        src = inp.contiguous()
        out = src.new_empty((group_size * src.shape[0],) + tuple(src.shape[1:]))
        pg._allgather_base(out, src).wait()
        return out

    return _run("all_gather", inp, go)


def _reduce_scatter(inp, reduce_op, group_size, group_name):
    import torch.distributed as dist

    pg = _group(group_name)

    def go():
        src = inp.contiguous()
        out = src.new_empty((src.shape[0] // group_size,) + tuple(src.shape[1:]))
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _op(reduce_op)
        pg._reduce_scatter_base(out, src, opts).wait()
        return out.div_(group_size) if reduce_op.lower() == "avg" else out

    return _run("reduce_scatter", inp, go)


def _all_to_all(inp, output_split_sizes, input_split_sizes, group_name):
    import torch.distributed as dist

    pg = _group(group_name)

    def go():
        src = inp.contiguous()
        rows = sum(output_split_sizes) if output_split_sizes else src.shape[0]
        out = src.new_empty((rows,) + tuple(src.shape[1:]))
        pg.alltoall_base(out, src, list(output_split_sizes), list(input_split_sizes),
                         dist.AllToAllOptions()).wait()
        return out

    return _run("all_to_all", inp, go)


def _broadcast(inp, src, group_name):
    import torch.distributed as dist

    pg = _group(group_name)

    def go():
        out = inp.clone(memory_format=torch.contiguous_format)
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        pg.broadcast([out], opts).wait()
        return out

    return _run("broadcast", inp, go)


_KERNELS = {
    "all_reduce": _all_reduce,
    "all_gather": _all_gather,
    "reduce_scatter": _reduce_scatter,
    "all_to_all": _all_to_all,
    "broadcast": _broadcast,
}


def route_collectives(device_type: str) -> None:
    """Route DTensor's functional collectives on ``device_type`` tensors
    through the process group's own collectives, counted and timed (module
    docstring).  Idempotent; lasts for the life of the process."""
    if device_type in _LIBRARIES:
        return
    keys = {"cuda": "CUDA", "cpu": "CPU"}
    if device_type not in keys:
        raise ValueError(f"collectives are routed for 'cuda' or 'cpu' tensors, not {device_type!r}")
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        # registering over the native kernel is the point; torch warns about it
        warnings.simplefilter("ignore")
        for name, op in COLLECTIVES.items():
            lib.impl(op, _KERNELS[name], keys[device_type])
    _LIBRARIES[device_type] = lib
