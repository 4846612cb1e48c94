"""PyTorch port, training slice: ``loss_fn`` value and gradients, three AdamW
steps, remat and gradient accumulation, the synthetic data, the optimizer
state's bridge, and the CPU launcher — each against the reference run
outside ``use_sharding`` (its sharded step builders fail on this
container's jax, ROADMAP "Where we are").

The loss runs the kernel path (``attn_impl="pallas"``, ``norm_impl="fused"``)
at seq 128, so the reference differentiates through its interpret-mode flash
and RMSNorm kernels and the port through its ``autograd.Function``s (their
plain versions on CPU tensors).  Tolerances: f32 2e-4, bf16 3e-2
(``tests/test_kernel_dtype_drift.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import DataLoader as JaxDataLoader, SyntheticConfig as JaxSynthConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state, warmup_cosine as jax_warmup_cosine
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataLoader, SyntheticConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainSettings, run_training
from repro_torch.models import model as PM
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.timing import TimingSession

SEQ, BATCH = 128, 2


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


def _configs(arch="llama3.2-1b", dtype="float32", kernels=True, **over):
    if kernels:
        over = dict(attn_impl="pallas", norm_impl="fused", **over)
    over["dtype"] = dtype
    return jax_smoke_config(arch).replace(**over), get_smoke_config(arch).replace(**over)


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 2e-4


def _close(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _batch(vocab, seq=SEQ, batch=BATCH, step=0, mode="copy"):
    """A reference synthetic batch (copy task: half the targets are -1) as
    numpy, jax and torch."""
    b = JaxSyntheticLM(JaxSynthConfig(vocab, seq, batch, mode=mode, seed=3)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _params(cfg_j, seed=0):
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
    return params_j, to_torch(jax.tree.map(np.asarray, params_j))


def _torch_value_and_grad(cfg, params, batch):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = PM.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, grads


def _assert_loss_and_grads_match(cfg_j, cfg_t, dtype):
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _batch(cfg_j.vocab_size)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True)(params_j)
    loss_t, metrics_t, grads_t = _torch_value_and_grad(cfg_t, params_t, batch_t)
    tol = _tol(dtype)
    _close(loss_t, loss_j, tol)
    for key in ("ce", "z_loss", "tokens", "aux"):
        _close(metrics_t[key], metrics_j[key], tol)
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for g_t, g_j, p in zip(grads_t, flat_j, tree_leaves(params_t)):
        assert g_t.dtype == p.dtype and g_t.shape == tuple(g_j.shape)
        _close(g_t, g_j, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    _assert_loss_and_grads_match(*_configs(dtype=dtype), dtype)


@pytest.mark.parametrize("variant", ["loss_chunk", "untied_padded_vocab", "qwen3_qk_norm"])
def test_loss_variants_match_jax(variant):
    """Chunked CE under checkpoint; an untied head over a padded vocab (250
    padded to 256: the mask keeps the pad columns out of the softmax); and
    qwen3-14b's smoke config, whose qk-norm runs ``RMSNormFused`` at hd 16."""
    over = {
        "loss_chunk": dict(loss_chunk=32),
        "untied_padded_vocab": dict(tied_embeddings=False, vocab_size=250),
        "qwen3_qk_norm": {},
    }[variant]
    arch = "qwen3-14b" if variant == "qwen3_qk_norm" else "llama3.2-1b"
    cfg_j, cfg_t = _configs(arch, **over)
    if variant == "untied_padded_vocab":
        assert cfg_t.padded_vocab == 256 and "lm_head" in PM.model_specs(cfg_t)
    if variant == "qwen3_qk_norm":
        assert cfg_t.use_qk_norm and cfg_t.resolved_head_dim == 16
    _assert_loss_and_grads_match(cfg_j, cfg_t, "float32")


@pytest.mark.parametrize("arch", ["glm4-9b", "minitron-8b"])
def test_other_dense_configs_take_a_step_on_the_plain_path(arch):
    cfg_j, cfg_t = _configs(arch, kernels=False)
    assert (cfg_t.attn_impl, cfg_t.norm_impl) == ("chunked", "ref")
    _assert_loss_and_grads_match(cfg_j, cfg_t, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax_loop(dtype):
    """``make_train_step`` against a JAX loop of ``M.loss_fn`` +
    ``adamw_update`` + ``warmup_cosine``: params, the optimizer state and
    the step's stats after each of three steps."""
    cfg_j, cfg_t = _configs(dtype=dtype)
    sched = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    params_j, params_t = _params(cfg_j)
    opt_j = jax_init_opt_state(JaxAdamWConfig(), params_j)
    opt_t = init_opt_state(AdamWConfig(), params_t)

    @jax.jit
    def jax_step(params, opt_state, batch):
        lr = jax_warmup_cosine(opt_state["step"], **sched)
        (_, metrics), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(cfg_j, p, batch), has_aux=True)(params)
        params, opt_state, stats = jax_adamw_update(JaxAdamWConfig(), params, grads,
                                                    opt_state, lr)
        return params, opt_state, {**metrics, **stats, "lr": lr}

    built = make_train_step(cfg_t, ShapeConfig("t", "train", SEQ, BATCH), **sched)
    assert built.tokens_per_call == SEQ * BATCH
    tol = _tol(dtype)
    for step in range(3):
        batch_j, batch_t = _batch(cfg_j.vocab_size, step=step)
        params_j, opt_j, stats_j = jax_step(params_j, opt_j, batch_j)
        params_t, opt_t, stats_t = built.fn(params_t, opt_t, batch_t)
        for key in ("loss", "grad_norm", "clip_scale", "lr"):
            _close(stats_t[key], stats_j[key], tol)
        assert opt_t["step"].dtype == torch.int32 and int(opt_t["step"]) == step + 1
        assert int(opt_j["step"]) == step + 1
        for name, got, ref in (("params", params_t, params_j), ("m", opt_t["m"], opt_j["m"]),
                               ("v", opt_t["v"], opt_j["v"]),
                               ("master", opt_t["master"], opt_j["master"])):
            for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
                assert str(g.dtype).split(".")[1] == r.dtype.name, name
                _close(g, r, tol)


def _grads_under(cfg, params, batch):
    params = tree_map(lambda p: p.clone(), params)
    return _torch_value_and_grad(cfg, params, batch)[2]


def test_remat_policies_give_the_same_grads_and_recompute_the_kernels(monkeypatch):
    """``remat`` none / full / dots give the same gradients.  Under "dots"
    and "full" the block forward runs again in the backward, so the flash
    and RMSNorm forwards are called twice per layer: the counts the card's
    launch counters are held to in ``chip_smoke.py`` (per layer: flash
    forward 2, dq 1, dkv 1, RMSNorm forward 4, RMSNorm backward 2)."""
    calls = {"fwd": 0, "rms": 0, "rms_bwd": 0, "bwd": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(fa_ops, "flash_fwd_plain", counting("fwd", fa_ops.flash_fwd_plain))
    monkeypatch.setattr(fa_ops, "flash_bwd_plain", counting("bwd", fa_ops.flash_bwd_plain))
    monkeypatch.setattr(rn_ops, "rms_norm_plain", counting("rms", rn_ops.rms_norm_plain))
    monkeypatch.setattr(rn_ops, "rms_norm_bwd_plain",
                        counting("rms_bwd", rn_ops.rms_norm_bwd_plain))
    cfg_j, cfg = _configs()
    _, params = _params(cfg_j)
    _, batch = _batch(cfg.vocab_size, seq=64)
    n = cfg.n_layers
    expected = {
        "none": {"fwd": n, "bwd": n, "rms": 2 * n, "rms_bwd": 2 * n},
        "full": {"fwd": 2 * n, "bwd": n, "rms": 4 * n, "rms_bwd": 2 * n},
        "dots": {"fwd": 2 * n, "bwd": n, "rms": 4 * n, "rms_bwd": 2 * n},
    }
    grads = {}
    for remat, want in expected.items():
        calls.update(dict.fromkeys(calls, 0))
        grads[remat] = _grads_under(cfg.replace(remat=remat), params, batch)
        assert calls == want, (remat, calls)
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_grad_accumulation_matches_one_batch():
    _, cfg = _configs(kernels=False)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg.vocab_size, seq=32, batch=4)
    shape = ShapeConfig("t", "train", 32, 4)
    out = {}
    for accum in (1, 2):
        built = make_train_step(cfg, shape, peak_lr=1e-2, warmup_steps=1, total_steps=10,
                                accum_steps=accum)
        p = tree_map(lambda x: x.clone(), params)
        out[accum] = built.fn(p, init_opt_state(AdamWConfig(), p), batch)
    (p1, o1, m1), (p2, o2, m2) = out[1], out[2]
    for key in ("loss", "ce", "grad_norm"):
        torch.testing.assert_close(m2[key], m1[key], atol=2e-5, rtol=2e-5)
    for a, b in zip(tree_leaves((p2, o2["m"], o2["v"])), tree_leaves((p1, o1["m"], o1["v"]))):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="must divide"):
        make_train_step(cfg, shape, accum_steps=3)


@pytest.mark.parametrize("mode", ["copy", "random", "skewed"])
def test_synthetic_batches_equal_the_reference_byte_for_byte(mode):
    _, cfg = _configs()
    for seed, step in ((0, 0), (5, 17)):
        ref = JaxSyntheticLM(JaxSynthConfig(256, 48, 3, mode=mode, seed=seed)).batch_at(step)
        got = SyntheticLM(SyntheticConfig(256, 48, 3, mode=mode, seed=seed), arch=cfg).batch_at(step)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype
            assert got[key].tobytes() == ref[key].tobytes()


def test_data_loader_streams_the_reference_batches():
    src_cfg = dict(vocab_size=256, seq_len=16, global_batch=2, mode="copy", seed=1)
    ref = JaxDataLoader(JaxSyntheticLM(JaxSynthConfig(**src_cfg)), start_step=4)
    got = DataLoader(SyntheticLM(SyntheticConfig(**src_cfg)), start_step=4)
    try:
        for _ in range(3):
            a, b = got.next(), ref.next()
            assert all(a[k].tobytes() == b[k].tobytes() for k in b)
        assert got.state() == ref.state() == {"step": 7}
    finally:
        got.close()
        ref.close()
    resumed = DataLoader.restore(SyntheticLM(SyntheticConfig(**src_cfg)), {"step": 7},
                                 prefetch=0)
    assert resumed.next()["tokens"].tobytes() == (
        JaxSyntheticLM(JaxSynthConfig(**src_cfg)).batch_at(7)["tokens"].tobytes())


def test_opt_state_bridges_bit_for_bit():
    """A JAX optimizer state (int32 step, f32 m / v / master of bf16 params)
    crosses to torch and back bit for bit; the port's ``init_opt_state`` on
    the bridged params builds the same tree."""
    cfg_j, cfg_t = _configs(dtype="bfloat16")
    params_j, params_t = _params(cfg_j)
    opt_j = jax_init_opt_state(JaxAdamWConfig(), params_j)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params_j)
    _, opt_j, _ = jax_adamw_update(JaxAdamWConfig(), params_j, grads, opt_j, jnp.float32(1e-3))
    ref = jax.tree.map(np.asarray, opt_j)
    back = to_numpy(to_torch(ref))
    assert back["step"].shape == () and back["step"].dtype == np.int32 and back["step"] == 1
    flat_ref, flat_back = jax.tree.leaves(ref), jax.tree.leaves(back)
    assert len(flat_ref) == len(flat_back)
    for a, b in zip(flat_back, flat_ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    mine = to_numpy(init_opt_state(AdamWConfig(), params_t))
    fresh = jax.tree.map(np.asarray, jax_init_opt_state(JaxAdamWConfig(), params_j))
    assert jax.tree.structure(mine) == jax.tree.structure(fresh)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(fresh)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert fresh["master"]["final_norm"].dtype == np.float32
    assert params_t["final_norm"].dtype == torch.bfloat16
    assert np.asarray(params_j["final_norm"]).dtype == ml_dtypes.bfloat16


def test_run_training_cpu_smoke():
    """The launcher on the CPU through the kernel path's plain versions:
    the structural assertions of ``tests/test_system.py`` (the checkpoint
    count aside: this run sets no ``ckpt_dir``), and the straggler
    detector's ``DIST/host0::step`` row mirrors ``EVOL/trainer::train_step``
    (its first check runs after the 8th step)."""
    settings = TrainSettings(arch="llama3.2-1b", smoke=True, steps=8, global_batch=2,
                             seq_len=32, report_every=0, device="cpu",
                             attn_impl="pallas", norm_impl="fused")
    sess = TimingSession()
    summary = run_training(settings, session=sess)
    assert summary["iterations"] == 8
    assert np.isfinite(summary["final_metrics"]["loss"])
    assert summary["final_metrics"]["lr"] > 0.0
    bins = summary["bin_seconds"]
    assert bins["EVOL"] > 0 and bins["STARTUP"] > 0
    assert summary["resume"] is None and summary["straggler_reports"] == 1

    def depth(row):
        return 1 + max((depth(c) for c in row["children"]), default=0)

    def check(row):
        child_sum = sum(c["inclusive_s"] for c in row["children"])
        assert child_sum <= row["inclusive_s"] + 1e-9, row["timer"]
        assert row["exclusive_s"] == pytest.approx(row["inclusive_s"] - child_sum)
        for c in row["children"]:
            check(c)

    forest = {row["timer"]: row for row in summary["timer_tree"]}
    total = forest["simulation/total"]
    assert depth(total) >= 3
    for row in summary["timer_tree"]:
        check(row)
    startup_bin = next(c for c in total["children"] if c["timer"] == "bin/STARTUP")
    driver = next(
        c for c in startup_bin["children"] if c["timer"] == "STARTUP/driver::startup"
    )
    names = {c["timer"] for c in driver["children"]}
    assert {"STARTUP/compile", "STARTUP/init_params",
            "STARTUP/driver::startup/steps::make_train_step"} <= names

    db = sess.db
    evol, dist = db.get("EVOL/trainer::train_step"), db.get("DIST/host0::step")
    assert dist.count == evol.count == 8
    assert dist.seconds() == pytest.approx(evol.seconds())
    channels = evol.read_flat()
    assert channels["tokens"] == 8 * 2 * 32 and channels["steps"] == 8
    assert channels["xla_flops"] == pytest.approx(8 * 6.0 * PM.param_counts(
        get_smoke_config("llama3.2-1b"))[1] * 2 * 32)


def test_unported_settings_name_their_roadmap_item():
    settings = TrainSettings(device="cpu", steps=1, pipeline_stages=2)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 6, distribution"):
        run_training(settings, session=TimingSession())


_EFFECT_STEPS = 3


def _manifest(ckpt_dir, step):
    import json
    import os

    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _on_disk(ckpt_dir):
    import os

    return sorted(int(n[5:]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and not n.endswith(".tmp"))


def _effect_ckpt_dir(ckpt, summary, sess, seen):
    # cold start: a resume scan that found nothing; AdaptCheck (adaptive by
    # default) admits the first write under the bound; SHUTDOWN's final save
    assert summary["resume"]["selected_step"] is None
    disk = _on_disk(ckpt)
    assert disk[0] == 1 and disk[-1] == _EFFECT_STEPS
    assert _manifest(ckpt, 1)["metadata"]["reason"] == "under-bound"
    assert _manifest(ckpt, _EFFECT_STEPS)["metadata"]["reason"] == "final"
    from repro_torch.checkpoint import load_checkpoint

    step, tree, _ = load_checkpoint(f"{ckpt}/step_{_EFFECT_STEPS:08d}")
    assert step == int(tree["opt_state"]["step"]) == int(tree["data"]["step"]) == _EFFECT_STEPS


def _effect_ckpt_mode(ckpt, summary, sess, seen):
    # "off": a manager for restores, but nothing admitted or written
    assert _on_disk(ckpt) == []
    assert summary["checkpoint"]["n_checkpoints"] == 0
    assert not sess.db.exists("CHECKPOINT/adaptcheck::write") or \
        sess.db.get("CHECKPOINT/adaptcheck::write").count == 0
    assert "adaptcheck" not in summary["adapt"]["controllers"]


def _effect_ckpt_every(ckpt, summary, sess, seen):
    # fixed mode, every iteration after the first (labels 2 and 3), then the
    # final save over label 3
    assert _on_disk(ckpt) == [2, 3]
    assert summary["checkpoint"]["n_checkpoints"] == _EFFECT_STEPS - 1
    assert _manifest(ckpt, 2)["metadata"]["reason"] == "fixed-interval"
    assert sess.db.get("CHECKPOINT/adaptcheck::write").count == _EFFECT_STEPS


def _effect_ckpt_max_fraction(ckpt, summary, sess, seen):
    from repro_torch.core import param_registry

    assert summary["checkpoint"]["max_fraction"] == 0.5
    assert param_registry().get("ckpt.max_fraction") == 0.5


def _effect_ckpt_max_interval_s(ckpt, summary, sess, seen):
    # the interval floor overrides a fraction bound nothing fits under
    assert summary["checkpoint"]["n_checkpoints"] == _EFFECT_STEPS
    assert [_manifest(ckpt, s)["metadata"]["reason"] for s in (1, 2)] == \
        ["max-interval"] * 2


def _effect_queue_seconds(ckpt, summary, sess, seen):
    # the queue ends within twice the predicted write: one forced final
    # checkpoint, then the fraction bound suppresses the rest
    assert _manifest(ckpt, 1)["metadata"]["reason"] == "queue-deadline-final"
    assert summary["checkpoint"]["n_checkpoints"] == 1
    assert _on_disk(ckpt) == [1, _EFFECT_STEPS]


def _effect_monitor_port(ckpt, summary, sess, seen):
    from repro_torch.monitor import parse_exposition

    exp = parse_exposition(seen["metrics"])
    assert exp.value("repro_timer_windows_total", path="EVOL/trainer::train_step",
                     chain="simulation/total>bin/EVOL") >= 1.0
    assert exp.types["repro_checkpoint_saves_total"] == "counter"
    assert seen["checkpoints"]["directory"] == ckpt
    assert seen["checkpoints"]["retention"]["keep_last_n"] == 3
    assert seen["status"]["iteration"] == seen["iteration"]


def _effect_metrics_textfile(ckpt, summary, sess, seen):
    from repro_torch.monitor import parse_exposition

    with open(seen["tmp"] + "/metrics.prom") as f:
        exp = parse_exposition(f.read())
    assert exp.value("repro_timer_windows_total", path="EVOL/trainer::train_step",
                     chain="simulation/total>bin/EVOL") == _EFFECT_STEPS


def _effect_status_path(ckpt, summary, sess, seen):
    import json

    with open(seen["tmp"] + "/status.json") as f:
        payload = json.load(f)
    assert payload["status"]["iteration"] == _EFFECT_STEPS - 1
    assert payload["status"]["loss"] == summary["final_metrics"]["loss"]
    assert "EVOL/trainer::train_step" in payload["timers"]


#: each setting that raised until checkpointing and the monitor were ported,
#: the companion settings its effect needs, and the check of that effect
_PORTED = {
    "ckpt_dir": ("CKPT", {}, _effect_ckpt_dir),
    "ckpt_mode": ("off", {"ckpt_dir": "CKPT"}, _effect_ckpt_mode),
    "ckpt_every": (1, {"ckpt_dir": "CKPT", "ckpt_mode": "fixed", "ckpt_keep_n": 10},
                   _effect_ckpt_every),
    "ckpt_max_fraction": (0.5, {"ckpt_dir": "CKPT"}, _effect_ckpt_max_fraction),
    "ckpt_max_interval_s": (1e-6, {"ckpt_dir": "CKPT", "ckpt_max_fraction": 1e-9,
                                   "ckpt_keep_n": 10}, _effect_ckpt_max_interval_s),
    "queue_seconds": (1.0, {"ckpt_dir": "CKPT", "ckpt_max_fraction": 1e-9,
                            "ckpt_keep_n": 10}, _effect_queue_seconds),
    "monitor_port": (0, {"ckpt_dir": "CKPT"}, _effect_monitor_port),  # 0: any free port
    "metrics_textfile": ("TMP/metrics.prom", {}, _effect_metrics_textfile),
    "status_path": ("TMP/status.json", {}, _effect_status_path),
}


@pytest.mark.parametrize("field", list(_PORTED))
def test_ported_settings_take_effect(field, tmp_path, capsys):
    import json
    import re
    import urllib.request

    value, extra, effect = _PORTED[field]
    ckpt = str(tmp_path / "ckpt")

    def resolve(v):
        if isinstance(v, str):
            return v.replace("CKPT", ckpt).replace("TMP", str(tmp_path))
        return v

    over = {k: resolve(v) for k, v in {**extra, field: value}.items()}
    settings = TrainSettings(device="cpu", steps=_EFFECT_STEPS, global_batch=2, seq_len=16,
                             report_every=0, **over)
    sess = TimingSession()
    seen = {"tmp": str(tmp_path)}

    def probe(s):
        # mid-run, while the monitor serves: read its endpoints once
        if field != "monitor_port" or "metrics" in seen:
            return
        port = re.search(r"monitor at http://127\.0\.0\.1:(\d+)/",
                         capsys.readouterr().out).group(1)
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            seen["metrics"] = resp.read().decode()
        for name in ("checkpoints", "status"):
            with urllib.request.urlopen(f"{base}/{name}", timeout=10) as resp:
                seen[name] = json.load(resp)
        seen["iteration"] = s.iteration

    sess.scheduler.schedule(probe, bin="OUTPUT", thorn="probe")
    summary = run_training(settings, session=sess)
    assert summary["iterations"] == _EFFECT_STEPS
    effect(ckpt, summary, sess, seen)


def test_adaptcheck_bounds_the_checkpoint_fraction(tmp_path):
    """AdaptCheck in adaptive mode, each write slowed by ``ckpt_delay_s``:
    the first decision admits under the bound, the weak bound then
    suppresses (no write starts above ``max_fraction``), every admission is
    an ``ADAPT/adaptcheck::checkpoint`` row, and steering the bound live
    through the registry takes effect from the next poll."""
    from repro_torch.core import param_registry

    steps, steer_at, bound = 10, 6, 0.2
    settings = TrainSettings(device="cpu", steps=steps, global_batch=2, seq_len=16,
                             report_every=0, ckpt_dir=str(tmp_path), ckpt_mode="adaptive",
                             ckpt_max_fraction=bound, ckpt_max_interval_s=1e9,
                             ckpt_delay_s=0.5, ckpt_synchronous=True, ckpt_keep_n=20)
    sess = TimingSession()

    def steer(s):
        if s.iteration == steer_at:
            param_registry().set("ckpt.max_fraction", 1.0, iteration=s.iteration)

    sess.scheduler.schedule(steer, bin="PRESTEP", thorn="steer")
    summary = run_training(settings, session=sess)

    actions = [a for a in sess.control_loop.actions
               if a.controller == "adaptcheck" and a.action == "checkpoint"]
    assert actions[0].step == 0 and actions[0].detail["reason"] == "under-bound"
    before = [a for a in actions if a.step < steer_at]
    assert all(a.detail["fraction"] <= bound for a in before), before
    assert len(before) < steer_at  # the bound suppressed something
    # steered to 1.0: every later poll admits
    assert [a.step for a in actions if a.step >= steer_at] == list(range(steer_at, steps))
    ckpt = summary["checkpoint"]
    assert ckpt["n_checkpoints"] == len(actions) and ckpt["n_suppressed"] >= 1
    assert sess.db.get("ADAPT/adaptcheck::checkpoint").count == len(actions)
    # every admitted write plus the final one, each at least the injected delay
    write = sess.db.get("CHECKPOINT/adaptcheck::write")
    assert write.count == len(actions) + 1 and write.seconds() >= 0.5 * write.count
    assert summary["ckpt_fraction"] == pytest.approx(
        write.seconds() / sess.db.get("simulation/total").seconds())
    assert _on_disk(str(tmp_path)) == sorted({a.step + 1 for a in actions} | {steps})
