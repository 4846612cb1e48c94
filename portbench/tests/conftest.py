"""CPU tests of the port's benchmark.  Run from the repository's root:

    python -m pytest portbench/tests -q

Tests marked ``cuda`` need the card and skip here."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))


@pytest.fixture(autouse=True)
def _fresh_port_registries():
    """The port's timer, clock and parameter registries are process-global."""
    import torch

    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_default_clocks()
    reset_param_registry()
    reset_timer_db()
    yield
    torch.set_num_threads(threads)


def load(name: str) -> dict:
    with open(DATA / name) as f:
        return json.load(f)


def tiny_spec(config: str, traffic: str, limits: dict, **load_extra):
    """A cell of the harness at test size: a tiny configuration and traffic
    from ``data/``, the repository's BENCHMARK.json for the metric lists."""
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}
    return harness.Spec(bench=bench, cell=cell, config=load(config), traffic=load(traffic),
                        load={"limits": limits, **load_extra}, root=ROOT)


@pytest.fixture
def cuda_device():
    """Skips a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
