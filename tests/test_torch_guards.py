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
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.launch.serve import run_serving
from repro_torch.models import model as PM
from repro_torch.models.layers import tree_leaves
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
    from repro_torch.faults.soak import checkpoint_drill, fleet_drill
    from repro_torch.soak import SoakConfig, run_soak

    with pytest.raises(gpu_errors):
        run_soak(SoakConfig(mode="serve", budget_s=0.1, scrape_http=False))
    # the simulated fleet's meshes, and the drills', refuse a card that is
    # not there
    with pytest.raises(ValueError, match="only 0 are visible"):
        run_soak(SoakConfig(mode="train", budget_s=0.1, scrape_http=False))
    with pytest.raises(ValueError, match="only 0 are visible"):
        fleet_drill(0, 4)
    with pytest.raises(ValueError, match="only 0 are visible"):  # its one pipeline stage
        checkpoint_drill(0, 2)
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


def test_recurrence_wrappers_refuse_other_devices():
    """The RG-LRU and WKV-6 wrappers route by device like the others: a mix
    of devices, or a device that is neither CPU nor CUDA, raises."""
    a = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="on cuda or all on cpu"):
        rg_ops.rglru_fwd(a, a)
    with pytest.raises(ValueError, match="on cuda or all on cpu"):
        rg_ops.rglru_fwd(torch.zeros((1, 8, 16)), torch.zeros((1, 8, 16)), torch.empty(
            (1, 16), device="meta"))
    r = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="on cuda or all on cpu"):
        wk_ops.wkv6_fwd(r, r, r, r, torch.zeros((2, 16)))


def test_registry_serves_hybrid_and_ssm_only_as_far_as_ported():
    assert {"recurrentgemma-9b", "rwkv6-1.6b", "moonshot-v1-16b-a3b",
            "kimi-k2-1t-a32b"} <= set(ARCH_IDS)
    assert get_config("recurrentgemma-9b").family == "hybrid"
    assert get_config("rwkv6-1.6b").family == "ssm"
    for arch in ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"):
        assert get_config(arch).family == get_smoke_config(arch).family == "moe"
    # the vlm family is ported: internvl2-26b resolves at both widths
    assert get_config("internvl2-26b").family == get_smoke_config("internvl2-26b").family == "vlm"
    # and the encdec family: seamless-m4t-large-v2 builds its encoder's and
    # its decoder's (xattn) specs
    encdec = get_smoke_config("seamless-m4t-large-v2")
    assert encdec.family == "encdec"
    specs = PM.model_specs(encdec)
    assert {"enc_scan", "enc_final_norm"} <= set(specs)
    assert {"self", "cross"} <= set(specs["scan"][0])
    assert "xlen" in PM.cache_specs(encdec, 1, 8)["scan"][0]
    cfg = get_smoke_config("recurrentgemma-9b")
    from repro_torch.models.config import MoESettings

    moe = cfg.replace(moe=MoESettings(n_experts=4, top_k=2, d_expert=32), dtype="float32")
    assert "moe" in PM.model_specs(moe)["scan"][0]
    params = PM.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    assert PM.forward(moe, params, batch).shape == (1, 4, moe.padded_vocab)
    # MoE configs train: the loss carries the routers' load-balancing loss
    _, metrics = PM.loss_fn(moe, params, dict(batch, targets=batch["tokens"]))
    assert torch.isfinite(metrics["aux"]) and float(metrics["aux"]) > 0
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.timing import TimingSession

    summary = run_training(TrainSettings(arch="moonshot-v1-16b-a3b", device="cpu", steps=1,
                                         global_batch=2, seq_len=32, report_every=0),
                           session=TimingSession())
    assert summary["iterations"] == 1 and np.isfinite(summary["final_metrics"]["loss"])
    # a vlm stack runs its patch prefix and scores the text positions
    vlm = get_smoke_config("internvl2-26b").replace(dtype="float32")
    params = PM.init_params(vlm, torch.Generator().manual_seed(0), "cpu")
    patches = torch.zeros((1, vlm.n_vision_patches, vlm.d_model))
    logits = PM.forward(vlm, params, dict(batch, patch_embeds=patches))
    assert logits.shape == (1, 4, vlm.padded_vocab) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown seq_impl"):
        PM.forward(cfg.replace(seq_impl="bogus", dtype="float32"),
                   PM.init_params(cfg.replace(dtype="float32"), torch.Generator(), "cpu"),
                   {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_bridge_round_trips_hybrid_and_ssm_params(arch):
    """Every leaf of a bf16 hybrid / ssm parameter tree, its f32 leaves
    (``lam``, ``w0``, ``u``) included, survives numpy and back bit for bit."""
    cfg = get_smoke_config(arch)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = tree_leaves(params)
    assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}
    back = to_torch(to_numpy(params))
    for a, b in zip(leaves, tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_wkv6_check_refuses_more_batch_heads_than_its_grid_holds():
    """The WKV-6 kernels put batch row x head on their grid's y axis, which
    CUDA caps at 65535: the wrapper's check refuses more, with a ValueError,
    before any launch."""
    u = torch.empty((1, 16), device="meta")
    wk_ops._check(*[torch.empty((65535, 1, 1, 16), device="meta")] * 4, u, None)
    r = torch.empty((65536, 1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="at most 65535 batch rows x heads"):
        wk_ops._check(r, r, r, r, u, None)


def test_fleet_ranks_load_neither_torch_nor_jax():
    """A rank spawns fast: ``import repro_torch.fleet`` and the worker module
    load none of torch, JAX or the reference package (the control-plane
    classes resolve lazily)."""
    code = (
        "import sys, runpy\n"
        "import repro_torch.fleet\n"
        "sys.argv = ['worker', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.fleet.worker', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'numpy' in sys.modules and 'repro_torch.fleet.worker' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--max-steps" in out.stdout
    out = subprocess.run([sys.executable, "-c", "import sys, repro_torch.fleet; "
                          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                          "('torch', 'numpy', 'jax', 'repro')))"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", (out.stdout, out.stderr)


def test_fleet_launcher_spawns_the_ports_worker(tmp_path, monkeypatch):
    """``run_fleet``'s ranks run ``-m repro_torch.fleet.worker`` with the
    checkout's ``src`` on their ``PYTHONPATH``."""
    from repro_torch.fleet import launch

    spawned = []

    class _Proc:
        def __init__(self, cmd, env, stdout, stderr):
            spawned.append((cmd, env))

        def send_signal(self, sig):
            pass

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(launch.subprocess, "Popen", _Proc)
    summary = launch.run_fleet(launch.FleetSettings(
        hosts=2, steps=2, poll_interval_s=0.0, liveness_timeout_s=60.0,
        rendezvous=str(tmp_path / "rdzv"), join_at=[(1, 5)]))
    assert summary["epoch"] == 1 and summary["finals"] == {}
    assert len(spawned) == 3
    for cmd, env in spawned:
        assert cmd[1:3] == ["-m", "repro_torch.fleet.worker"]
        assert str(ROOT / "src") in env["PYTHONPATH"].split(os.pathsep)
    assert spawned[-1][0][-1] == "--join" and spawned[-1][0][cmd.index("--host") + 1] == "5"


def _dtensor_guard_worker(rank, world):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.meshutil import device_mesh

    mesh = device_mesh((1, 1), device="cpu")

    def dt(*shape):
        return DTensor.from_local(torch.randn(shape), mesh, [Replicate(), Replicate()])

    q, k, lse = dt(1, 8, 2, 16), dt(1, 8, 1, 16), dt(1, 2, 8)
    x, w = dt(8, 32), dt(32)
    calls = {
        "flash_fwd": lambda: fa_ops.flash_fwd(q, k, k),
        "flash_bwd_dq": lambda: fa_ops.flash_bwd_dq(q, k, k, q, lse, lse),
        "flash_bwd_dkv": lambda: fa_ops.flash_bwd_dkv(q, k, k, q, lse, lse),
        "rmsnorm_fwd": lambda: rn_ops.rms_norm_fwd(x, w),
        "rmsnorm_bwd": lambda: rn_ops.rms_norm_bwd(x, w, x),
        "rglru_fwd": lambda: rg_ops.rglru_fwd(x[None], x[None]),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except TypeError as exc:
            refused[name] = str(exc)
    shared = {}
    for allow in (False, True):
        try:
            device_mesh((1, 1), device="cuda", allow_shared_card=allow)
            shared[allow] = None
        except ValueError as exc:
            shared[allow] = str(exc)
    return refused, shared


def test_kernel_wrappers_refuse_dtensors_and_device_mesh_refuses_a_shared_card():
    """A DTensor that reaches a kernel wrapper raises TypeError naming the
    kernel (the model hands kernels local shards), and ``device_mesh`` on
    "cuda" refuses more ranks than cards unless ``allow_shared_card`` (one
    rank, no card here)."""
    from repro_torch.dist.spawn import run_ranks

    refused, shared = run_ranks(_dtensor_guard_worker, 1)[0]
    for name, message in refused.items():
        assert message is not None and message.startswith(f"{name}: got a DTensor"), (name,
                                                                                       message)
    assert "pass allow_shared_card=True" in shared[False]
    assert "needs a CUDA device" in shared[True]
