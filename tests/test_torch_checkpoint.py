"""PyTorch port, checkpoint layer: the cases of ``tests/test_checkpoint.py``
and ``tests/test_faults.py`` on the port's modules with tensor trees, and
checkpoints crossing between the packages — a checkpoint written by either
restores in the other with bit-equal leaves and equal per-leaf sha256, and
the port's trainer resumes from one the reference wrote."""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig, init_opt_state as jax_init_opt_state
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointManager,
    RetentionPolicy,
    load_checkpoint,
    plan_resume,
    save_checkpoint,
    scan_checkpoints,
    validate_checkpoint,
)
from repro_torch.faults import (
    CHECKPOINT_FAULTS,
    FaultEvent,
    FaultPlan,
    apply_checkpoint_event,
    apply_fleet_event,
    bit_flip_leaf,
    drop_commit,
    drop_leaf,
    drop_manifest,
    partial_manifest,
    seeded_rng,
    simulate_writer_kill,
    truncate_leaf,
)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's); torch on one thread."""
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


def _tree():
    """Every leaf kind a training state holds: f32, bf16 and int32 tensors,
    plain Python scalars, empty containers and ``None`` holes."""
    return {
        "params": {
            "scan": (
                {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
                {"w": torch.ones((2, 2), dtype=torch.float32),
                 "b": torch.linspace(-2, 2, 5).to(torch.bfloat16)},
            ),
            "tail": (),
            "none_slot": None,
        },
        "step_list": [torch.tensor(3, dtype=torch.int32), 1.5],
        "data": {"step": 7},
    }


def _flat(tree, prefix=""):
    """(path, leaf) pairs and container kinds: the structure as a list."""
    if isinstance(tree, dict):
        out = [(prefix, "dict", tuple(tree))]
        for k, v in tree.items():
            out += _flat(v, f"{prefix}/{k}")
        return out
    if isinstance(tree, (tuple, list)):
        out = [(prefix, type(tree).__name__, len(tree))]
        for i, v in enumerate(tree):
            out += _flat(v, f"{prefix}/{i}")
        return out
    if tree is None:
        return [(prefix, "none", None)]
    return [(prefix, "leaf", tree)]


def _as_tensor(leaf):
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))


def _assert_tree_equal(got, want):
    """Same structure; every leaf a tensor of the same dtype, shape and bits."""
    fg, fw = _flat(got), _flat(want)
    assert [x[:2] for x in fg] == [x[:2] for x in fw]
    for (path, kind, a), (_, _, b) in zip(fg, fw):
        if kind != "leaf":
            assert a == b, path
            continue
        assert isinstance(a, torch.Tensor), path
        b = _as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# io + manager (the cases of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    path, nbytes = save_checkpoint(str(tmp_path), 7, _tree(), metadata={"k": "v"})
    assert nbytes > 0 and os.path.basename(path) == "step_00000007"
    step, tree, meta = load_checkpoint(path)
    assert step == 7 and meta["k"] == "v"
    _assert_tree_equal(tree, _tree())
    assert tree["params"]["scan"][1]["b"].dtype == torch.bfloat16
    with open(os.path.join(path, "manifest.json")) as f:
        entries = {e["dtype"]: e["stored_dtype"] for e in json.load(f)["leaves"]}
    assert entries["bfloat16"] == "uint16" and entries["int32"] == "int32"


def test_crc_detects_corruption(tmp_path):
    path, _ = save_checkpoint(str(tmp_path), 1, _tree())
    leaf = os.path.join(path, "leaf_00000.npy")
    data = bytearray(open(leaf, "rb").read())
    data[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(data))
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(path)


def test_uncommitted_checkpoint_rejected(tmp_path):
    path, _ = save_checkpoint(str(tmp_path), 1, _tree())
    os.remove(os.path.join(path, "COMMITTED"))
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(path)


def test_manager_restore_latest_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), synchronous=True)
    mgr.save(1, _tree())
    mgr.save(2, _tree())
    newest = mgr.checkpoints()[-1][1]
    os.remove(os.path.join(newest, "COMMITTED"))
    step, tree, _ = mgr.restore_latest()
    assert step == 1
    _assert_tree_equal(tree, _tree())
    mgr.close()


def test_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, synchronous=False)
    for step in range(5):
        stats = mgr.save(step, {"x": torch.full((64,), float(step))})
        assert stats["blocking_seconds"] >= 0.0 and stats["nbytes"] == 64 * 4
    mgr.wait()
    steps = [s for s, _ in mgr.checkpoints()]
    assert steps == [3, 4]  # keep_n=2
    step, tree, _ = mgr.restore_latest()
    assert step == 4 and float(tree["x"][0]) == 4.0
    mgr.close()


def test_snapshot_is_not_the_live_tensor(tmp_path):
    """The optimizer updates its state in place: an async write must hold
    the values of the moment ``save`` returned, not the live tensor's."""
    live = {"m": torch.zeros(1 << 16)}
    mgr = CheckpointManager(str(tmp_path), synchronous=False, delay_s=0.2)
    mgr.save(0, live)
    live["m"].add_(1.0)  # the next step, while the write is still sleeping
    mgr.wait()
    _, tree, _ = mgr.restore_latest()
    assert float(tree["m"].abs().max()) == 0.0
    mgr.close()


def test_async_blocking_time_smaller_than_sync_with_slow_fs(tmp_path):
    """The beyond-paper async win: blocking time excludes the slow write."""
    big = {"x": torch.zeros(1 << 20)}  # 4 MB
    sync = CheckpointManager(str(tmp_path / "sync"), synchronous=True, delay_s=0.2)
    s_sync = sync.save(0, big)
    sync.close()
    asy = CheckpointManager(str(tmp_path / "async"), synchronous=False, delay_s=0.2)
    s_async = asy.save(0, big)
    asy.close()
    assert s_sync["blocking_seconds"] >= 0.2
    assert s_async["blocking_seconds"] < s_sync["blocking_seconds"] / 2


def test_manager_restore_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest() is None
    mgr.close()


def test_io_counter_channels_updated(tmp_path):
    from repro_torch.core.clocks import counter_channel

    before_bytes = counter_channel("io_bytes")
    before_ops = counter_channel("io_ops")
    mgr = CheckpointManager(str(tmp_path), synchronous=True)
    stats = mgr.save(0, {"x": torch.zeros(10), "y": torch.zeros(3, dtype=torch.bfloat16)})
    mgr.close()
    assert stats["nbytes"] == 10 * 4 + 3 * 2
    assert counter_channel("io_bytes") == before_bytes + stats["nbytes"]
    assert counter_channel("io_ops") == before_ops + 1


def test_retention_keep_every_k(tmp_path):
    """keep_last_n ∪ keep_every_k: milestones survive the rolling window."""
    mgr = CheckpointManager(str(tmp_path), keep_n=2, keep_every_k=4, synchronous=True)
    for step in range(10):
        mgr.save(step, {"x": torch.full((8,), float(step))})
    steps = [s for s, _ in mgr.checkpoints()]
    assert steps == [0, 4, 8, 9]  # every-4 milestones + newest 2
    mgr.close()


def test_retention_policy_semantics():
    pol = RetentionPolicy(keep_last_n=2, keep_every_k=5)
    steps = [1, 3, 5, 7, 10, 11]
    assert pol.keeps(steps) == {5, 10, 11}  # newest two ∪ multiples of 5
    assert pol.doomed(steps) == [1, 3, 7]
    assert RetentionPolicy(keep_last_n=5).doomed([1, 2]) == []
    with pytest.raises(ValueError):
        RetentionPolicy(keep_last_n=-1)


def test_gc_never_deletes_newest_valid(tmp_path):
    """Retention would keep only the 2 newest — but when those are corrupt,
    the newest checkpoint that actually validates is exempt from deletion."""
    for step in range(1, 6):
        save_checkpoint(str(tmp_path), step, {"x": torch.full((8,), float(step))})
    for step in (4, 5):
        os.remove(os.path.join(str(tmp_path), f"step_{step:08d}", "COMMITTED"))
    mgr = CheckpointManager(str(tmp_path), keep_n=2, synchronous=True)
    deleted = mgr.gc()
    assert 3 not in deleted, "newest valid checkpoint must never be GC'd"
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000003"))
    step, tree, _ = mgr.restore_latest()
    assert step == 3 and float(tree["x"][0]) == 3.0
    mgr.close()


def test_restore_quarantines_with_reason_and_counts(tmp_path):
    """restore_latest never silently skips: the corrupt directory is moved to
    corrupt/ with a REASON.txt and the failure counter is bumped."""
    from repro_torch.core.clocks import counter_channel

    mgr = CheckpointManager(str(tmp_path), synchronous=True)
    mgr.save(1, _tree())
    mgr.save(2, _tree())
    newest = mgr.checkpoints()[-1][1]
    os.remove(os.path.join(newest, "COMMITTED"))
    before = counter_channel("ckpt_validation_failures")
    step, _, _ = mgr.restore_latest()
    assert step == 1
    assert counter_channel("ckpt_validation_failures") == before + 1
    q = mgr.quarantined()
    assert len(q) == 1 and q[0]["reason"] == "missing_commit"
    assert mgr.last_resume_plan.summary()["n_quarantined"] == 1
    mgr.close()


def test_sha256_manifest_and_streamed_validation(tmp_path):
    """v2 manifests carry per-leaf sha256 + size, hashed during the write."""
    import hashlib

    path, _ = save_checkpoint(str(tmp_path), 3, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 2
    for leaf in manifest["leaves"]:
        assert len(leaf["sha256"]) == 64 and leaf["nbytes"] > 0
        with open(os.path.join(path, leaf["file"]), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == leaf["sha256"]
        assert len(data) == leaf["nbytes"]
    assert validate_checkpoint(path)["step"] == 3


def test_manager_status_payload(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, synchronous=True)
    mgr.save(1, _tree())
    payload = mgr.status_payload()
    assert payload["retention"]["keep_last_n"] == 2
    assert [c["step"] for c in payload["checkpoints"]] == [1]
    assert payload["totals"]["n_saves"] == 1
    assert payload["totals"]["total_bytes"] == (12 + 4) * 4 + 5 * 2 + 4
    json.dumps(payload)
    mgr.close()


def test_concurrent_scans_during_async_writes(tmp_path):
    """The fs-lock discipline: scans/restores race the async writer's GC
    without tripping over half-deleted directories."""
    mgr = CheckpointManager(str(tmp_path), keep_n=2, synchronous=False)
    errors = []

    def scanner():
        try:
            for _ in range(60):
                mgr.checkpoints()
                mgr.resume_plan(quarantine=False)
        except Exception as exc:  # noqa: BLE001 - the test asserts none happen
            errors.append(exc)

    threads = [threading.Thread(target=scanner) for _ in range(3)]
    for t in threads:
        t.start()
    for step in range(12):
        mgr.save(step, {"x": torch.full((2048,), float(step))})
    mgr.wait()
    for t in threads:
        t.join()
    assert not errors
    steps = [s for s, _ in mgr.checkpoints()]
    assert steps[-1] == 11 and len(steps) >= 2
    mgr.close()


def test_wait_timeout_keeps_pending(tmp_path):
    """A timed-out wait must not drop the in-flight write: a later wait can
    still make it durable."""
    mgr = CheckpointManager(str(tmp_path), synchronous=False, delay_s=0.3)
    mgr.save(0, {"x": torch.zeros(8)})
    with pytest.raises(TimeoutError):
        mgr.wait(timeout=0.01)
    mgr.wait()  # finishes the same write
    assert [s for s, _ in mgr.checkpoints()] == [0]
    mgr.close()


_SIGTERM_CHAIN_SCRIPT = """\
import os, signal, sys
import torch
torch.set_num_threads(1)
from repro_torch.checkpoint import CheckpointManager

mode = sys.argv[2]
if mode == "chain":
    def prior(signum, frame):
        print("PRIOR_HANDLER_RAN", flush=True)
        sys.exit(0)
    signal.signal(signal.SIGTERM, prior)
# mode == "default": leave SIG_DFL installed -> handler must re-kill

mgr = CheckpointManager(sys.argv[1], synchronous=True)
mgr.install_sigterm_handler(
    lambda: (7, {"w": torch.ones(8), "h": torch.ones(3, dtype=torch.bfloat16)}),
    deadline_s=5.0,
)
os.kill(os.getpid(), signal.SIGTERM)
print("UNREACHABLE", flush=True)
"""


def _run_sigterm_script(tmp_path, mode):
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHAIN_SCRIPT, str(tmp_path), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


def test_sigterm_handler_saves_then_chains_previous(tmp_path):
    """Preemption: the emergency save lands AND the previously installed
    handler still runs afterwards (chained, not clobbered)."""
    rc, out, err = _run_sigterm_script(tmp_path, "chain")
    assert rc == 0, err
    assert "PRIOR_HANDLER_RAN" in out and "UNREACHABLE" not in out
    step, tree, meta = load_checkpoint(os.path.join(str(tmp_path), "step_00000007"))
    assert step == 7 and meta["emergency"] is True and meta["met_deadline"] is True
    assert torch.equal(tree["w"], torch.ones(8))
    assert torch.equal(tree["h"], torch.ones(3, dtype=torch.bfloat16))


def test_sigterm_handler_saves_then_default_terminates(tmp_path):
    """With SIG_DFL previously installed, the handler saves and then re-raises
    the default termination (exit by signal, not a normal return)."""
    import signal

    rc, out, _ = _run_sigterm_script(tmp_path, "default")
    assert rc == -signal.SIGTERM
    assert "UNREACHABLE" not in out
    step, _, meta = load_checkpoint(os.path.join(str(tmp_path), "step_00000007"))
    assert step == 7 and meta["emergency"] is True


def test_unknown_logical_dtype_raises(tmp_path):
    """A logical dtype with no tensor counterpart is refused at load."""
    path, _ = save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4, dtype=torch.int16)})
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["leaves"][0]["dtype"] = "float4_e2m1fn"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(TypeError, match="float4_e2m1fn"):
        load_checkpoint(path, verify=False)


# ---------------------------------------------------------------------------
# fault injection (the cases of tests/test_faults.py)
# ---------------------------------------------------------------------------

def _ftree(step: int = 0):
    return {
        "w": torch.arange(256, dtype=torch.float32) + step,
        "b": torch.full((32,), float(step)),
    }


def _two_checkpoints(root) -> tuple[str, str]:
    old, _ = save_checkpoint(str(root), 1, _ftree(1))
    new, _ = save_checkpoint(str(root), 2, _ftree(2))
    return old, new


#: the corruption matrix: injector -> the reason validation must report
MATRIX = [
    (lambda p: bit_flip_leaf(p, 0, rng=seeded_rng(7)), "leaf_hash_mismatch"),
    (lambda p: truncate_leaf(p, 0), "leaf_size_mismatch"),
    (lambda p: drop_leaf(p, 0), "missing_leaf"),
    (drop_manifest, "missing_manifest"),
    (partial_manifest, "manifest_unreadable"),
    (drop_commit, "missing_commit"),
]


@pytest.mark.parametrize("injector,reason", MATRIX, ids=[r for _, r in MATRIX])
def test_corruption_detected_quarantined_recovered(tmp_path, injector, reason):
    from repro_torch.core.clocks import counter_channel
    from repro_torch.core.timers import timer_db

    _, newest = _two_checkpoints(tmp_path)
    injector(newest)
    # 1. detected at validation time, with the right reason, without loading
    with pytest.raises(CheckpointCorrupt) as exc_info:
        validate_checkpoint(newest)
    assert exc_info.value.reason == reason
    # 2. the resume plan quarantines it (REASON.txt), counts it and selects
    # the fallback
    before = counter_channel("ckpt_validation_failures")
    plan = plan_resume(str(tmp_path), quarantine=True)
    assert counter_channel("ckpt_validation_failures") == before + 1
    assert timer_db().exists(f"CHECKPOINT/quarantine::{reason}")
    assert plan.selected is not None and plan.selected.step == 1
    assert [r.reason for r in plan.corrupt] == [reason]
    quarantined = os.path.join(str(tmp_path), "corrupt", "step_00000002")
    assert os.path.isdir(quarantined)
    with open(os.path.join(quarantined, "REASON.txt")) as f:
        assert reason in f.read()
    # 3. a manager restore recovers past it to the last known good
    mgr = CheckpointManager(str(tmp_path), synchronous=True)
    step, tree, _ = mgr.restore_latest()
    assert step == 1
    assert torch.equal(tree["w"], _ftree(1)["w"])
    mgr.close()


def test_validation_failures_counted_and_reported(tmp_path):
    from repro_torch.core.clocks import counter_channel
    from repro_torch.core.timers import timer_db

    _, newest = _two_checkpoints(tmp_path)
    drop_commit(newest)
    before = counter_channel("ckpt_validation_failures")
    plan_resume(str(tmp_path), quarantine=True)
    assert counter_channel("ckpt_validation_failures") == before + 1
    assert timer_db().exists("CHECKPOINT/quarantine::missing_commit")


def test_stale_tmp_debris_quarantined(tmp_path):
    """A SIGKILLed writer can only leave a ``.tmp`` directory; the scanner
    must classify it as ``stale_tmp`` and the resume sweep it aside."""
    _two_checkpoints(tmp_path)
    debris = simulate_writer_kill(str(tmp_path), 3, rng=seeded_rng(3))
    records = scan_checkpoints(str(tmp_path))
    assert {r.reason for r in records if r.status != "valid"} == {"stale_tmp"}
    plan = plan_resume(str(tmp_path), quarantine=True)
    assert plan.selected.step == 2
    assert not os.path.exists(debris)
    assert os.path.isdir(os.path.join(str(tmp_path), "corrupt"))


def test_every_plan_kind_dispatches(tmp_path):
    """``apply_checkpoint_event`` covers the whole matrix: each kind leaves
    the target either invalid or (kill_writer) with stale debris."""
    for kind in CHECKPOINT_FAULTS:
        root = tmp_path / kind
        root.mkdir()
        path, _ = save_checkpoint(str(root), 1, _ftree())
        event = FaultEvent(step=0, kind=kind, target=0)
        touched = apply_checkpoint_event(event, path, rng=seeded_rng(kind))
        if kind == "kill_writer":
            assert touched.endswith(".tmp") and os.path.isdir(touched)
            validate_checkpoint(path)  # original untouched
        else:
            with pytest.raises(CheckpointCorrupt):
                validate_checkpoint(path)


def test_fault_plan_deterministic():
    from repro.faults import FaultPlan as JaxFaultPlan

    a = FaultPlan.random(11, 500, hosts=(0, 1, 2))
    b = FaultPlan.random(11, 500, hosts=(0, 1, 2))
    assert a.events == b.events
    assert len(a.events) > 0
    event = a.events[0]
    assert a.rng_for(event).random() == b.rng_for(event).random()
    c = FaultPlan.random(12, 500, hosts=(0, 1, 2))
    assert c.events != a.events
    # the copy draws the reference's schedule from the same seed
    ref = JaxFaultPlan.random(11, 500, hosts=(0, 1, 2))
    assert [(e.step, e.kind, e.target, e.arg) for e in a.events] == \
        [(e.step, e.kind, e.target, e.arg) for e in ref.events]


class _Fleet:
    """The three fleet-fault methods ``apply_fleet_event`` calls, over a
    per-host cost table (the reference's ``SimulatedFleet`` semantics)."""

    def __init__(self, n_hosts: int) -> None:
        self.nominal = {h: 1.0 + h for h in range(n_hosts)}
        self.costs = dict(self.nominal)

    def slow_host(self, host: int, factor: float) -> None:
        self.costs[host] = self.nominal[host] * factor

    def hang_host(self, host: int, factor: float) -> None:
        self.slow_host(host, factor)

    def restore_host(self, host: int) -> None:
        self.costs[host] = self.nominal[host]


def test_fleet_faults_roundtrip():
    fleet = _Fleet(2)
    nominal = dict(fleet.costs)
    apply_fleet_event(FaultEvent(step=0, kind="hang_host", target=1), fleet)
    assert fleet.costs[1] == nominal[1] * 1000.0
    apply_fleet_event(FaultEvent(step=1, kind="slow_host", target=0, arg=3.0), fleet)
    assert fleet.costs[0] == nominal[0] * 3.0
    apply_fleet_event(FaultEvent(step=2, kind="restore_host", target=0), fleet)
    apply_fleet_event(FaultEvent(step=2, kind="restore_host", target=1), fleet)
    assert fleet.costs == nominal
    with pytest.raises(ValueError, match="needs a target"):
        apply_fleet_event(FaultEvent(step=3, kind="slow_host"), fleet)


def test_bitflip_deterministic_from_seed(tmp_path):
    """Same seed, same flip: a failing drill replays byte-for-byte."""
    flips = []
    for name in ("a", "b"):
        root = tmp_path / name
        root.mkdir()
        path, _ = save_checkpoint(str(root), 1, _ftree())
        bit_flip_leaf(path, rng=seeded_rng(99))
        with open(os.path.join(path, "leaf_00000.npy"), "rb") as f:
            flips.append(f.read())
    assert flips[0] == flips[1]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

ARCH, SEED = "llama3.2-1b", 5


def _reference_state(label: int = 2):
    """llama3.2-1b smoke params and AdamW state made by the reference from a
    seed, as numpy (bf16 params, f32 master and moments, int32 step)."""
    cfg = jax_smoke_config(ARCH)
    params = JM.init_params(cfg, jax.random.PRNGKey(SEED))
    opt_state = jax_init_opt_state(JaxAdamWConfig(), params)
    # moments that are not all zeros, so a swapped leaf cannot pass
    keys = iter(jax.random.split(jax.random.PRNGKey(SEED + 1), 64))
    for name in ("m", "v"):
        opt_state[name] = jax.tree.map(
            lambda x: jax.random.uniform(next(keys), x.shape, x.dtype), opt_state[name])
    opt_state["step"] = opt_state["step"] + label
    tree = {"params": params, "opt_state": opt_state, "data": {"step": label}}
    return jax.tree.map(np.asarray, tree)


def _leaves_by_path(tree, prefix=""):
    return {path: leaf for path, kind, leaf in _flat(tree, prefix) if kind == "leaf"}


def _sha_by_path(ckpt_path):
    """Per-leaf sha256 of a manifest, keyed by the leaf's tree path."""
    with open(os.path.join(ckpt_path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}

    def walk(skel, prefix):
        kind = skel["__t"]
        if kind == "dict":
            for k, v in skel["items"].items():
                walk(v, f"{prefix}/{k}")
        elif kind in ("tuple", "list"):
            for i, v in enumerate(skel["items"]):
                walk(v, f"{prefix}/{i}")
        elif kind == "leaf":
            entry = manifest["leaves"][skel["idx"]]
            out[prefix] = (entry["sha256"], entry["dtype"], entry["stored_dtype"])

    walk(manifest["skeleton"], "")
    return out


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _reference_state()
    path, _ = jax_ckpt.save_checkpoint(str(tmp_path), 2, state, metadata={"by": "repro"})
    step, tree, meta = load_checkpoint(path)
    assert step == 2 and meta == {"by": "repro"}
    want = to_torch(state)
    _assert_tree_equal(tree, want)
    assert tree["params"]["final_norm"].dtype == torch.bfloat16
    assert tree["opt_state"]["master"]["final_norm"].dtype == torch.float32
    assert tree["opt_state"]["step"].dtype == torch.int32
    assert int(tree["data"]["step"]) == 2


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Port -> reference: every leaf bit-equal, and both packages' manifests
    hold the same sha256 for every leaf path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as PM
    from repro_torch.optim import AdamWConfig, init_opt_state

    params = PM.init_params(get_smoke_config(ARCH), torch.Generator().manual_seed(SEED), "cpu")
    opt_state = init_opt_state(AdamWConfig(), params)
    gen = torch.Generator().manual_seed(SEED + 1)
    for name in ("m", "v"):
        for t in _leaves_by_path(opt_state[name]).values():
            t.copy_(torch.rand(t.shape, generator=gen))
    tree = {"params": params, "opt_state": opt_state, "data": {"step": 4}}
    path, _ = save_checkpoint(str(tmp_path / "port"), 4, tree)
    as_numpy = {"params": to_numpy(params), "opt_state": to_numpy(opt_state),
                "data": {"step": 4}}

    step, loaded, _ = jax_ckpt.load_checkpoint(path, verify=True)
    assert step == 4
    want = _leaves_by_path(as_numpy)
    got = _leaves_by_path(loaded)
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        b = np.asarray(want[key])
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key

    ref_path, _ = jax_ckpt.save_checkpoint(str(tmp_path / "ref"), 4, as_numpy)
    assert _sha_by_path(path) == _sha_by_path(ref_path)


def test_port_trainer_resumes_from_a_reference_checkpoint(tmp_path):
    """``run_training(restore=True)`` on a checkpoint the reference wrote: the
    first step's loss equals the port's loss from the same state (bridged
    with ``to_torch``) on the batch at the restored label."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.models import model as PM
    from repro_torch.timing import TimingSession

    label, seq, batch = 2, 32, 2
    state = _reference_state(label)
    jax_ckpt.save_checkpoint(str(tmp_path), label, state)
    settings = TrainSettings(
        arch=ARCH, smoke=True, steps=label + 1, global_batch=batch, seq_len=seq,
        ckpt_dir=str(tmp_path), ckpt_mode="off", restore=True, report_every=0,
        device="cpu", attn_impl="pallas", norm_impl="fused", lr_total_steps=8,
    )
    summary = run_training(settings, session=TimingSession())
    assert summary["iterations"] == label + 1
    assert summary["resume"]["selected_step"] == label
    assert summary["resume"]["n_valid"] == 1 and summary["resume"]["n_quarantined"] == 0

    cfg = get_smoke_config(ARCH).replace(attn_impl="pallas", norm_impl="fused")
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch, mode="copy", seed=0),
                       arch=cfg).batch_at(label)
    with torch.no_grad():
        loss, _ = PM.loss_fn(cfg, to_torch(state["params"]),
                             {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(summary["final_metrics"]["loss"], float(loss),
                               rtol=2e-5, atol=2e-5)
    # ckpt_mode "off": the restore wrote nothing back
    assert sorted(os.listdir(tmp_path)) == [f"step_{label:08d}"]
