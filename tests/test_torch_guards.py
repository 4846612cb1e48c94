"""PyTorch port, guards: the bridge is bit-exact, the port and
``chip_smoke.py`` import neither JAX nor ``repro``, and the entry points that
default to the GPU raise on a CPU-only machine instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.serve import run_serving
from repro_torch.models import model as PM
from repro_torch.serving import ServeSession

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's), and run torch on one
    CPU thread: the shapes are tiny, and idle-spinning intra-op threads would
    slow the timing-sensitive tests that share the machine."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    yield
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    torch.set_num_threads(threads)


def test_bridge_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    special = np.array([0x7FC0, 0xFF80, 0x7F80, 0x0001, 0x8000, 0x3F80], np.uint16)
    bf16 = np.concatenate([special, rng.integers(0, 2**16, 58, dtype=np.uint16)])
    tree = {
        "w": bf16.view(ml_dtypes.bfloat16).reshape(8, 8),
        "scan": ({"k": rng.standard_normal((2, 3), dtype=np.float32)}, None),
        "tail": (),
        "pos": np.arange(4, dtype=np.int32),
    }
    tt = to_torch(tree)
    assert tt["w"].dtype == torch.bfloat16 and tt["scan"][1] is None and tt["tail"] == ()
    back = to_numpy(tt)
    np.testing.assert_array_equal(back["w"].view(np.uint16), tree["w"].view(np.uint16))
    assert back["w"].dtype == tree["w"].dtype
    np.testing.assert_array_equal(back["scan"][0]["k"], tree["scan"][0]["k"])
    assert back["pos"].dtype == np.int32
    np.testing.assert_array_equal(back["pos"], tree["pos"])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_and_chip_smoke_import_no_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(ROOT)}:{line}: {name}"
        for f in files
        for line, name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(modules)


def test_gpu_entry_points_raise_without_a_gpu():
    """Entry points default to ``cuda``: on a CPU-only machine they raise,
    they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run on it")
    cfg = get_smoke_config("llama3.2-1b")
    gpu_errors = (RuntimeError, AssertionError)
    with pytest.raises(gpu_errors):
        PM.init_params(cfg, torch.Generator())
    with pytest.raises(gpu_errors):
        PM.init_cache(cfg, 1, 16)
    params = PM.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(gpu_errors):
        ServeSession(cfg, params)
    with pytest.raises(gpu_errors):
        run_serving(n_requests=1)
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_all()


def test_kernel_wrappers_refuse_other_devices():
    """CPU tensors take the plain version; anything that is neither CPU nor
    CUDA, or a mix, raises instead of being routed somewhere."""
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="on cuda or all on cpu"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="on cuda or all on cpu"):
        rn_ops.rms_norm_fused(torch.empty((4, 32), device="meta"), torch.ones(32))
