#!/usr/bin/env python3
"""Which collectives ``torch.distributed``'s gloo backend carries on CUDA
tensors, through DTensor's ``redistribute``, for ranks that share one card:

    python3 tools/probe_collectives.py [--world 2] [--device cuda] [--backend gloo]

Spawns ``--world`` processes (a ``file://`` rendezvous in a temporary
directory), every rank on ``cuda:0`` (``rank % device_count``), a
``("data",)`` DeviceMesh over them, and tries on bf16 and f32 tensors:

* ``all_reduce``      Partial -> Replicate
* ``all_gather``      Shard(0) -> Replicate
* ``reduce_scatter``  Partial -> Shard(0)
* ``broadcast``       ``distribute_tensor(..., [Replicate()])`` from rank 0
* ``all_to_all``      Shard(0) -> Shard(1)

and the raw process-group call under each (``dist.all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast``,
``all_to_all_single``).  Each result is checked against the value computed
on one rank; a case reports ``ok``, ``wrong`` or the exception's type and
first line, and with ``ok`` the median milliseconds of 5 calls on a
16 Mi-element payload.  Each collective runs in processes of its own, so
one that kills a rank is reported as the signal it died of.  With
``--device cpu`` it runs the same on the host.
Prints the card's name and power limit (``nvidia-smi``), then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ELEMS = 1 << 24
CASES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all",
         "pg_all_reduce", "pg_all_gather", "pg_reduce_scatter", "pg_broadcast", "pg_all_to_all")


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip().splitlines()
    return f"{type(exc).__name__}: {text[0][:160] if text else ''}"


def _rank(rank: int, world: int, init: str, device: str, backend: str, out: str,
          only: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    warnings.simplefilter("ignore")
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    mesh = init_device_mesh(device, (world,), mesh_dim_names=("data",))
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device(device, torch.cuda.current_device())

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        fn()
        sync()
        times = []
        for _ in range(5):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[2]

    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        gen = torch.Generator().manual_seed(0)
        full = torch.randn((world * 4, world * 8), generator=gen).to(dtype)
        parts = [torch.randn(full.shape, generator=gen).to(dtype) for _ in range(world)]
        total = sum(p.float() for p in parts).to(dtype)
        mine = parts[rank].to(dev)
        big = torch.ones(ELEMS, dtype=dtype, device=dev)
        big2 = big.reshape(world * 64, -1)

        def dt_cases():
            return {
                "all_reduce": (
                    lambda: DTensor.from_local(mine, mesh, [Partial()], run_check=False)
                    .redistribute(mesh, [Replicate()]).to_local(),
                    total,
                    lambda: DTensor.from_local(big, mesh, [Partial()], run_check=False)
                    .redistribute(mesh, [Replicate()]).to_local()),
                "all_gather": (
                    lambda: DTensor.from_local(full.chunk(world, 0)[rank].to(dev), mesh,
                                               [Shard(0)], run_check=False)
                    .redistribute(mesh, [Replicate()]).to_local(),
                    full,
                    lambda: DTensor.from_local(big, mesh, [Shard(0)], run_check=False)
                    .redistribute(mesh, [Replicate()]).to_local()),
                "reduce_scatter": (
                    lambda: DTensor.from_local(mine, mesh, [Partial()], run_check=False)
                    .redistribute(mesh, [Shard(0)]).to_local(),
                    total.chunk(world, 0)[rank],
                    lambda: DTensor.from_local(big, mesh, [Partial()], run_check=False)
                    .redistribute(mesh, [Shard(0)]).to_local()),
                "broadcast": (
                    lambda: distribute_tensor((full if rank == 0 else full * 0).to(dev), mesh,
                                              [Replicate()]).to_local(),
                    full,
                    lambda: distribute_tensor(big, mesh, [Replicate()]).to_local()),
                "all_to_all": (
                    lambda: DTensor.from_local(full.chunk(world, 0)[rank].to(dev), mesh,
                                               [Shard(0)], run_check=False)
                    .redistribute(mesh, [Shard(1)]).to_local(),
                    full.chunk(world, 1)[rank],
                    lambda: DTensor.from_local(big2, mesh, [Shard(0)], run_check=False)
                    .redistribute(mesh, [Shard(1)]).to_local()),
            }

        def pg_all_reduce(x):
            y = x.clone()
            dist.all_reduce(y)
            return y

        def pg_all_gather(x):
            y = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(y, x)
            return y

        def pg_reduce_scatter(x):
            y = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(y, x)
            return y

        def pg_broadcast(x):
            y = x.clone()
            dist.broadcast(y, 0)
            return y

        def pg_all_to_all(x):
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return y

        shard0 = full.chunk(world, 0)[rank].to(dev)
        pg_cases = {
            "pg_all_reduce": (lambda: pg_all_reduce(mine), total,
                              lambda: pg_all_reduce(big)),
            "pg_all_gather": (lambda: pg_all_gather(shard0), full,
                              lambda: pg_all_gather(big)),
            "pg_reduce_scatter": (lambda: pg_reduce_scatter(mine),
                                  total.chunk(world, 0)[rank], lambda: pg_reduce_scatter(big)),
            "pg_broadcast": (lambda: pg_broadcast((full if rank == 0 else full * 0).to(dev)),
                             full, lambda: pg_broadcast(big)),
            "pg_all_to_all": (lambda: pg_all_to_all(mine),
                              torch.cat([parts[r].chunk(world, 0)[rank] for r in range(world)]),
                              lambda: pg_all_to_all(big)),
        }
        for case, (fn, want, big_fn) in {**dt_cases(), **pg_cases}.items():
            if case != only:
                continue
            try:
                got = fn()
                sync()
                if got.device.type != dev.type:
                    raise RuntimeError(f"result on {got.device}")
                ok = torch.allclose(got.float().cpu(), want.float(), rtol=1e-2, atol=1e-2)
                row = {"result": "ok" if ok else "wrong"}
                if ok:
                    row["ms_16Mi"] = round(timed(big_fn), 4)
            except Exception as exc:  # noqa: BLE001 - the probe reports each failure
                row = {"result": _first_line(exc)}
            results[f"{case}/{name}"] = row
            dist.barrier()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(results, fh)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    results = {}
    for case in CASES:
        # each case in processes of its own: a collective that kills a rank
        # (a signal) is reported and the next case still runs
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "probe.json")
            init = f"file://{os.path.join(tmp, 'rdzv')}"
            try:
                mp.start_processes(
                    _rank, args=(args.world, init, args.device, args.backend, out, case),
                    nprocs=args.world, join=True, start_method="spawn")
                with open(out) as fh:
                    results.update(json.load(fh))
            except Exception as exc:  # noqa: BLE001 - the probe reports each failure
                for dtype in ("bfloat16", "float32"):
                    results[f"{case}/{dtype}"] = {"result": _first_line(exc)}
    for case, row in results.items():
        print(f"  {case:28s} {row}")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "world": args.world, "device": args.device, "backend": args.backend,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
