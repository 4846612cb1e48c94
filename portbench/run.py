"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and the device's busy and
window seconds from a profiled window.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit); the last lines of standard error repeat
the checks.  Without a CUDA device, with fewer than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: every build and kernel cache of the program and of torch, at fixed paths
#: inside the checkout (build/ is not committed)
CACHES = {
    "TORCH_EXTENSIONS_DIR": "build/portbench-cache/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench-cache/triton",
    "PYTORCH_KERNEL_CACHE_PATH": "build/portbench-cache/torch_kernels",
    "CUDA_CACHE_PATH": "build/portbench-cache/cuda",
}


def _setup_env() -> None:
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()

    from portbench import harness

    spec = harness.load_spec(args.workload)
    import torch

    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.log(T_START, f"torch {torch.__version__} on {torch.cuda.get_device_name(0)}")
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out["memory_peak"])}
    line = assemble(spec, out, bool(args.trace), device)
    for text in harness.check_lines(out["checks"]):
        print(text, file=sys.stderr)
    print(line, flush=True)
    return 0


def run_cell(spec, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """Run the cell's runner (chosen by its traffic's ``kind``)."""
    kind = spec.traffic["kind"]
    if kind == "train":
        from portbench import train_cell as runner
    elif kind == "serve":
        from portbench import serve_cell as runner
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    return runner.run(spec, seed, seconds, trace, device, T_START)


def assemble(spec, out: dict, trace: bool, device: dict) -> str:
    """The result line: end-to-end metrics, or per-layer ones with ``trace``."""
    from portbench import harness

    metrics = {}
    breakdown = None
    if not trace:
        for m in harness.end_to_end_for(spec):
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
    else:
        ctx = out["ctx"]
        for m in harness.per_layer_for(spec):
            value = harness.read_metric(spec.root, m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx.trace is not None:
            device = dict(device, busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
            breakdown = ctx.trace.breakdown()
    correct = out["failed"] == 0 and all(v <= lim for v, lim in out["checks"].values())
    return harness.result_line(correct=correct, attempted=out["attempted"], failed=out["failed"],
                               metrics=metrics, device=device, checks=out["checks"],
                               breakdown=breakdown)


if __name__ == "__main__":
    sys.exit(main())
