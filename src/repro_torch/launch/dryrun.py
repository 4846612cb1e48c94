"""Multi-pod dry run: build every (architecture x input-shape x mesh) cell's
step against the production meshes and record, for one device, its state
bytes, memory, FLOPs and collective bytes — the port's counterpart of
``src/repro/launch/dryrun.py`` ("deliverable e").

The reference lowers and compiles each cell against 512 placeholder *host*
devices, so nothing is allocated on any accelerator.  The port does the
same on the host: it starts a ``fake`` process group of 256 or 512 ranks in
this one process (``launch.mesh.start_fake_group``; this process is rank 0,
its collectives move nothing), lays the cell's params, optimizer state,
batch and cache out on the production ``DeviceMesh`` as DTensors whose
local shards are CPU fake tensors (``FakeTensorMode``: shapes and dtypes,
no storage), and runs the built step once.  The kernels' wrappers take
their plain versions on CPU tensors, as on any CPU tensor.  This is an
analysis, not a fallback: it allocates nothing on any device and computes
no value.  The recorder (``launch.hlo``) sees the ops rank 0 runs below
DTensor on its own shards, so every number is one device's.

Each cell runs the port's kernel path, as the card runs it
(``chip_smoke.py``): ``attn_impl="pallas"``, ``norm_impl="fused"`` and, in
prefill and decode, ``seq_impl="pallas"`` (training keeps the recurrences'
``"parallel"`` forms: the recurrence kernels have no backward).  The
recorder counts each kernel's plain version as the kernel (its outputs
live, its FLOPs counted).

Eager PyTorch runs every layer, so nothing is counted once for a whole
scan and no scan correction is needed: ``scan_bodies`` stays empty
(the reference's ``_scan_corrected`` compiles reduced-depth variants to
scale XLA's once-counted while bodies).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # full matrix
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Artifacts: artifacts/dryrun/<arch>__<shape>__<mesh>[__opt].json with
``state_bytes`` (params, optimizer state and cache bytes a device, from the
placements), ``memory_analysis`` (argument bytes; the peak of live local
bytes over the step; its outputs' bytes), ``cost_analysis`` (the local
matmul FLOPs), ``collective_operand_bytes_per_device`` (by opcode),
``op_census`` and ``wall_seconds``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..dist.sharding import mesh_sizes
from ..models import model as M
from ..models.config import SHAPES, shape_applicable

ARTIFACT_DIR = os.path.join("artifacts", "dryrun")

__all__ = ["run_cell", "kernel_path", "optimized_settings", "main", "ARTIFACT_DIR"]


def _shard_shape(shape, spec, sizes: dict[str, int]) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under a PartitionSpec."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for axis in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            out[dim] //= sizes[axis]
    return tuple(out)


def _sharded_nbytes(abstract_tree, shardings, sizes: dict[str, int]) -> int:
    """Per-device bytes of a tree of ``PSpec`` stand-ins under its
    PartitionSpecs (one device's shard shapes)."""
    from ..models.layers import tree_leaves

    return sum(math.prod(_shard_shape(s.shape, p, sizes)) * s.dtype.itemsize
               for s, p in zip(tree_leaves(abstract_tree), tree_leaves(shardings)))


def _fake_tree(abstract_tree, shardings, mesh, sharded: bool):
    """Fake tensors of a ``PSpec`` tree (inside ``FakeTensorMode``): DTensors
    of fake local shards on a sharded mesh, whole fakes otherwise."""
    import torch

    from ..dist.sharding import placements_for
    from ..models.layers import tree_map

    sizes = mesh_sizes(mesh)

    def one(spec, part):
        if not sharded:
            return torch.empty(spec.shape, dtype=spec.dtype)
        from torch.distributed.tensor import DTensor

        local = torch.empty(_shard_shape(spec.shape, part, sizes), dtype=spec.dtype)
        return DTensor.from_local(local, mesh, placements_for(part, mesh), run_check=False)

    return tree_map(one, abstract_tree, shardings)


def _run_step(shape, built, mesh, step_kwargs):
    """Run ``built.fn`` once on fake inputs under the recorder; returns
    (recorder, its outputs' local bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..optim import AdamWConfig, init_opt_state
    from .hlo import Recorder, _local, _tensors
    from .steps import _is_sharded

    sharded = _is_sharded(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_tree(built.abstract_state["params"], built.in_shardings[0], mesh, sharded)
        if shape.kind == "train":
            opt_cfg = (step_kwargs or {}).get("opt_cfg") or AdamWConfig()
            state = (params, init_opt_state(opt_cfg, params))
            inputs = (_fake_tree(built.abstract_inputs[0], built.in_shardings[2], mesh,
                                 sharded),)
        else:
            state = (params,)
            inputs = tuple(_fake_tree(a, p, mesh, sharded)
                           for a, p in zip(built.abstract_inputs, built.in_shardings[1:]))
        with Recorder((state, inputs)) as rec:
            out = built.fn(*state, *inputs)
            out_bytes = sum(_local(t).numel() * t.element_size() for t in _tensors(out))
        del out, state, inputs, params
    return rec, out_bytes


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    out_dir: str = ARTIFACT_DIR,
    rules_overrides: dict[str, Any] | None = None,
    variant: str = "baseline",
    arch_overrides: dict[str, Any] | None = None,
    verbose: bool = True,
    step_kwargs: dict[str, Any] | None = None,
    smoke: bool = False,
    mesh=None,
    mesh_label: str | None = None,
    shape_override=None,
) -> dict[str, Any]:
    """Build and run one cell on fake tensors; write and return the artifact
    record.

    ``smoke``/``mesh``/``mesh_label``/``shape_override`` support reduced-scale
    dry runs: the SMOKE_CONFIG instead of the published shape, an explicit
    ``DeviceMesh`` (over any process group: a fake one, or real ranks)
    instead of the production one, and a custom ShapeConfig — the artifact's
    ``mesh`` field carries the label.  Without ``mesh`` a fake group of the
    production mesh's size is started (``launch.mesh.start_fake_group``).
    """
    from .mesh import MULTI_POD_SHAPE, POD_SHAPE, make_production_mesh, start_fake_group
    from .steps import build_step, rules_for

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = shape_override if shape_override is not None else SHAPES[shape_name]
    cfg = cfg.replace(**kernel_path(shape.kind))
    if arch_overrides:
        cfg = cfg.replace(**arch_overrides)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = mesh_label or ("multi" if multi_pod else "single")
    record: dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "variant": variant,
        "status": "skipped",
    }
    if not ok:
        record["skip_reason"] = why
        _write(record, out_dir)
        if verbose:
            print(f"[dryrun] {arch} × {shape.name} × {mesh_name}: SKIP ({why})")
        return record

    t0 = time.monotonic()
    if mesh is None:
        start_fake_group(math.prod(MULTI_POD_SHAPE if multi_pod else POD_SHAPE))
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = rules_for(cfg, rules_overrides)
    built = build_step(cfg, mesh, rules, shape, **(step_kwargs or {}))
    rec, out_bytes = _run_step(shape, built, mesh, step_kwargs)

    from .hlo import collective_bytes, op_census

    sizes = mesh_sizes(mesh)
    abstract, parts = built.abstract_state, built.in_shardings
    state_bytes = {"params_bytes_per_device": _sharded_nbytes(abstract["params"], parts[0],
                                                              sizes)}
    if shape.kind == "train":
        state_bytes["opt_bytes_per_device"] = _sharded_nbytes(abstract["opt_state"], parts[1],
                                                              sizes)
    if shape.kind == "prefill":
        state_bytes["cache_bytes_per_device"] = _sharded_nbytes(built.abstract_inputs[1],
                                                                parts[2], sizes)
    if shape.kind == "decode":
        state_bytes["cache_bytes_per_device"] = _sharded_nbytes(built.abstract_inputs[0],
                                                                parts[1], sizes)
    mem = {"argument_size_in_bytes": rec.argument_bytes, "output_size_in_bytes": out_bytes,
           "peak_bytes": rec.peak_bytes,
           "temp_size_in_bytes": rec.peak_bytes - rec.argument_bytes}
    coll = collective_bytes(rec)
    total, active = M.param_counts(cfg)
    record.update(
        {
            "status": "ok",
            "kind": shape.kind,
            "n_chips": math.prod(sizes.values()),
            "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "tokens_per_step": shape.tokens_per_step,
            "params_total": total,
            "params_active": active,
            "memory_analysis": mem,
            "state_bytes": state_bytes,
            "cost_analysis": {"flops": float(rec.flops)},
            "collective_operand_bytes_per_device": coll,
            "scan_bodies": [],
            "op_census": op_census(rec),
            "sharding_preset": cfg.sharding,
            "accum_steps": int((step_kwargs or {}).get("accum_steps", 1)),
            "wall_seconds": round(time.monotonic() - t0, 2),
        }
    )
    _write(record, out_dir)
    if verbose:
        print(
            f"[dryrun] {arch} × {shape.name} × {mesh_name} [{variant}]: OK "
            f"flops/dev={rec.flops:.3e} coll_bytes/dev={sum(coll.values()):.3e} "
            f"state/dev={sum(state_bytes.values()) / 1e9:.3f} GB "
            f"peak/dev={rec.peak_bytes / 1e9:.3f} GB (total {record['wall_seconds']:.1f}s)"
        )
    return record


def kernel_path(kind: str) -> dict[str, str]:
    """The config fields that put a cell of ``kind`` on the kernel path."""
    return {"attn_impl": "pallas", "norm_impl": "fused",
            "seq_impl": "parallel" if kind == "train" else "pallas"}


def _write(record: dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if record.get("variant", "baseline") == "baseline" else f"__{record['variant']}"
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def optimized_settings(arch: str, shape_name: str):
    """The reference's per-cell performance knobs (``--preset optimized``).

    Returns (arch_overrides, rules_overrides, step_kwargs).
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    arch_over: dict[str, Any] = {"embed_gather_constraint": True}
    rules_over: dict[str, Any] | None = None
    step_kwargs: dict[str, Any] | None = None
    if cfg.moe is not None:
        arch_over["moe_dispatch_mode"] = "tokens"
    if shape.kind == "train":
        arch_over.update({"loss_chunk": 512, "remat": "full"})
        step_kwargs = {"accum_steps": 8 if shape.global_batch % 8 == 0 else 1}
    if shape.kind == "decode" and cfg.n_kv_heads < 16:
        rules_over = {"kv_seq": "model"}
    return arch_over, rules_over, step_kwargs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="full matrix")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--preset", choices=["baseline", "optimized"], default="baseline",
                    help="optimized = the reference's per-cell knobs (variant 'opt')")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    # one fake group a mesh: the mesh loop is the outer one
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                variant = "baseline" if args.preset == "baseline" else "opt"
                vsuffix = "" if variant == "baseline" else "__opt"
                suffix = f"{arch}__{shape}__{mesh_name}{vsuffix}.json"
                if args.skip_existing and os.path.exists(os.path.join(args.out, suffix)):
                    print(f"[dryrun] {suffix}: exists, skipping")
                    continue
                kwargs: dict[str, Any] = {}
                if args.preset == "optimized":
                    ao, ro, sk = optimized_settings(arch, shape)
                    kwargs = dict(arch_overrides=ao, rules_overrides=ro,
                                  step_kwargs=sk, variant="opt")
                try:
                    run_cell(arch, shape, mesh_name == "multi", out_dir=args.out, **kwargs)
                except Exception:  # noqa: BLE001
                    failures.append((arch, shape, mesh_name))
                    print(f"[dryrun] {arch} × {shape} × {mesh_name}: FAILED")
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
