"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs the cell once and assembles the result line.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric sits in a file of its own, found by name:

* ``configs/<config>.json``: the configuration (the ``file`` of its entry);
* ``traffic/<traffic>.json``: a traffic mix, read by ``traffic.py``;
* ``workloads/<cell>.json``: the cell's load (rate, slots) and the limits of
  its correctness check;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``, which
  returns a number or None (nothing to read: the metric is left out); a
  metric ``<base>.<part>`` without a file of its own takes ``<base>.py``;
* ``ops/<op>/*.json``: the names (regular expressions) of the device
  operations that do one kind of work, one file a kernel;
* ``reference/<module>.py``: a configuration's plain reference (its
  ``reference`` key).

A traffic file's ``kind`` picks the runner (``train_cell`` or
``serve_cell``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Spec", "load_spec", "Context", "per_layer_for", "end_to_end_for", "metric_path",
           "read_metric", "window_record", "op_patterns", "reference_module", "log",
           "forbidden_modules", "result_line", "check_lines"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: what the result line shows for a compared number that is not finite
UNREADABLE = 1e30


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """One cell: its entries in BENCHMARK.json and its files."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    load: dict
    root: Path

    @property
    def name(self) -> str:
        return self.cell["name"]


def load_spec(workload: str, root: Path = ROOT, bench: dict | None = None) -> Spec:
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    here = root / "portbench"
    return Spec(bench=bench, cell=cell, config=_json(root / entry["file"]),
                traffic=_json(here / "traffic" / f"{cell['traffic']}.json"),
                load=_json(here / "workloads" / f"{workload}.json"), root=root)


def per_layer_for(spec: Spec) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec.bench["end_to_end"]
           if "workloads" not in m or spec.name in m["workloads"]}
    out = []
    for m in spec.bench["per_layer"]:
        if "workloads" in m:
            if spec.name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end_for(spec: Spec) -> list[dict]:
    return [m for m in spec.bench["end_to_end"]
            if "workloads" not in m or spec.name in m["workloads"]]


def _module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_path(root: Path, name: str) -> Path:
    """``metrics/<name>.py``, or for ``<base>.<part>`` without a file of its
    own the shared ``metrics/<base>.py``."""
    here = root / "portbench" / "metrics"
    path = here / f"{name}.py"
    if not path.exists() and "." in name:
        path = here / f"{name.rsplit('.', 1)[0]}.py"
    return path


def read_metric(root: Path, name: str, ctx: Any) -> float | None:
    """Run the metric's reader (``metric_path``): ``read(ctx)``."""
    path = metric_path(root, name)
    mod = _module(path, "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name))
    value = mod.read(ctx)
    return None if value is None else float(value)


def op_patterns(root: Path, op: str) -> list[str]:
    """The name patterns of every kernel file under ``ops/<op>/``."""
    out: list[str] = []
    for path in sorted((root / "portbench" / "ops" / op).glob("*.json")):
        out.extend(_json(path)["patterns"])
    return out


def reference_module(spec: Spec):
    path = spec.root / "portbench" / "reference" / f"{spec.config['reference']}.py"
    return _module(path, "portbench_reference_" + spec.config["reference"])


def window_record(opened, closed) -> tuple[dict[str, tuple[float, float]], dict[str, float]]:
    """What the program's timers and counters gained between two
    ``program.timer_record`` readings: ({timer: (seconds, windows)},
    {counter: amount}), over every timer and counter of the second."""
    (spans0, counters0), (spans1, counters1) = opened, closed
    spans = {k: (s - spans0.get(k, (0.0, 0.0))[0], n - spans0.get(k, (0.0, 0.0))[1])
             for k, (s, n) in spans1.items()}
    return spans, {k: v - counters0.get(k, 0.0) for k, v in counters1.items()}


@dataclass
class Context:
    """What a per-layer metric's reader may read (see ``metrics/``): the
    window's length, its device trace (traced runs), what each of the
    program's timers (``spans``: seconds, completed windows) and counters
    gained in the window (``window_record``), and the runner's own counts of
    the window's work (``values``)."""

    spec: Spec
    window_s: float
    trace: Any = None  # trace.Trace of the traced window
    values: dict[str, Any] = field(default_factory=dict)
    spans: dict[str, tuple[float, float]] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    def ops(self, op: str) -> list[str]:
        return op_patterns(self.spec.root, op)

    def roofline(self, op: str, flops: float, bytes_: float) -> float | None:
        """Percent of the least time the work needs (``work.least_seconds``)
        over the device time of the operations ``ops/<op>/`` names; None
        without a trace or without such operations."""
        from .work import least_seconds

        if self.trace is None:
            return None
        seconds = self.trace.op_seconds(self.ops(op))
        if seconds <= 0.0:
            return None
        return 100.0 * least_seconds(flops, bytes_) / seconds

    def idle_share(self) -> float | None:
        """Percent of the traced window in which no device operation ran."""
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def log(t_start: float, text: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    import time

    print(f"portbench [{time.perf_counter() - t_start:8.2f} s] {text}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def check_lines(checks: dict[str, tuple[float, float]]) -> list[str]:
    return [f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in checks.items()]


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict[str, tuple[float, float]],
                breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v if finite(v) else UNREADABLE, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out, allow_nan=False)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
