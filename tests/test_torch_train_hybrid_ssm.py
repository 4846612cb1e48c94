"""PyTorch port, training of the hybrid and SSM families: the
recurrentgemma-9b and rwkv6-1.6b smoke configs with the kernel settings
(``attn_impl="pallas"``, ``norm_impl="fused"``, ``seq_impl="parallel"``)
against the reference on weights bridged from its ``init_params``.

* ``loss_fn``'s value, metrics and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` (f32 and bf16);
* three AdamW steps of ``make_train_step`` against a JAX loop of the
  reference's ``loss_fn`` + ``adamw_update`` + ``warmup_cosine`` (f32);
* the kernel calls a training step makes under ``remat="dots"``: the counts
  ``chip_smoke.py`` phases 18 and 19 hold the card's launch counters to;
* ``run_training(device="cpu")`` for a few steps on each.

Sequence 128: the reference's Pallas flash kernels tile it (block 128), so
the reference differentiates recurrentgemma's local attention (window 16)
through its interpret-mode ``flash_bwd_dq``/``flash_bwd_dkv`` and the port
through its ``autograd.Function`` (the plain versions on CPU tensors).  The
recurrences train through the jnp forms the reference's blocks call
(``linear_recurrence(impl="assoc")``, ``wkv6_chunked``) and their PyTorch
counterparts.

Tolerances: f32 2e-4 (``tests/test_kernel_dtype_drift.py``).  bf16: the
reference's own tolerance for whole-model comparisons of these families
across reduction orders, atol 0.15 / rtol 0.05
(``tests/test_serve_consistency.py:143``, as ``test_torch_hybrid_ssm.py``
holds their bf16 logits): XLA on the CPU keeps bf16 elementwise chains in
f32 inside its fusions where the port rounds after each op, and the
recurrences' decays and gates pass those roundings on through every step of
the sequence and every layer into the gradients (at 3e-2, one of the two
families missed on 16 of 16384 elements of one leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticConfig as JaxSynthConfig, SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state, warmup_cosine as jax_warmup_cosine
from repro_torch.bridge import to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainSettings, run_training
from repro_torch.models import model as PM
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.timing import TimingSession

ARCHS = ("recurrentgemma-9b", "rwkv6-1.6b")
KERNELS = dict(attn_impl="pallas", norm_impl="fused", seq_impl="parallel")
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


def _configs(arch, dtype="float32"):
    """(reference config, port config); the reference has no ``seq_impl``:
    its blocks always train through the parallel forms."""
    over = dict(attn_impl="pallas", norm_impl="fused", dtype=dtype)
    return (jax_smoke_config(arch).replace(**over),
            get_smoke_config(arch).replace(**over, seq_impl="parallel"))


def _close(got, ref, dtype):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    atol, rtol = (2e-4, 2e-4) if dtype == "float32" else (0.15, 0.05)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _batch(vocab, step=0):
    """A reference copy-task batch (half the targets are -1) as jax and torch."""
    b = JaxSyntheticLM(JaxSynthConfig(vocab, SEQ, BATCH, mode="copy", seed=3)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _params(cfg_j):
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    return params_j, to_torch(jax.tree.map(np.asarray, params_j))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, dtype):
    cfg_j, cfg_t = _configs(arch, dtype)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _batch(cfg_j.vocab_size)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True)(params_j)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params_t)]
    loss_t, metrics_t = PM.loss_fn(cfg_t, params_t, batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    _close(loss_t, loss_j, dtype)
    for key in ("ce", "z_loss", "tokens", "aux"):
        _close(metrics_t[key], metrics_j[key], dtype)
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for g_t, g_j, p in zip(grads_t, flat_j, leaves):
        assert g_t.dtype == p.dtype and g_t.shape == tuple(g_j.shape)
        assert bool(torch.isfinite(g_t).all())
        _close(g_t, g_j, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax_loop(arch):
    """``make_train_step`` against a JAX loop of ``loss_fn`` +
    ``adamw_update`` + ``warmup_cosine`` in f32: the step's stats, the
    params and the optimizer state after each of three steps."""
    cfg_j, cfg_t = _configs(arch)
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
    for step in range(3):
        batch_j, batch_t = _batch(cfg_j.vocab_size, step=step)
        params_j, opt_j, stats_j = jax_step(params_j, opt_j, batch_j)
        params_t, opt_t, stats_t = built.fn(params_t, opt_t, batch_t)
        for key in ("loss", "grad_norm", "clip_scale", "lr"):
            _close(stats_t[key], stats_j[key], "float32")
        assert int(opt_t["step"]) == int(opt_j["step"]) == step + 1
        for got, ref in ((params_t, params_j), (opt_t["m"], opt_j["m"]),
                         (opt_t["v"], opt_j["v"]), (opt_t["master"], opt_j["master"])):
            for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
                _close(g, r, "float32")


def _per_step_calls(cfg):
    """Kernel calls of one training step under ``remat="dots"``, from the
    model's structure: the stacked units run their forward twice (again in
    the backward), the tail layers once.  Each attention layer is one flash
    forward per forward run and one dq and one dkv; each layer normalizes
    twice (ln and ln2; rwkv three times: ln1, the per-head group norm, ln2)
    per forward run and once each in the backward; the final norm is the
    unfused one.  So rwkv6-1.6b (24 layers, all stacked): 6L RMSNorm
    forwards, 3L backwards, no flash; recurrentgemma-9b cut to 4 layers (one
    stacked (rglru, attn_local, attn_local) unit, an rglru tail): 4 flash
    forwards, 2 dq, 2 dkv, 14 RMSNorm forwards, 8 backwards."""
    kinds = cfg.layer_kinds()
    n_stacked = (cfg.n_layers // len(cfg.block_pattern)) * len(cfg.block_pattern)
    runs = [2 if i < n_stacked else 1 for i in range(cfg.n_layers)]
    norms = [3 if kind == "rwkv" else 2 for kind in kinds]
    attn = [kind.startswith("attn") for kind in kinds]
    return {
        "flash_fwd": sum(r for r, a in zip(runs, attn) if a),
        "flash_bwd": sum(attn),
        "rms": sum(r * n for r, n in zip(runs, norms)),
        "rms_bwd": sum(norms),
        "rglru": 0,
        "wkv6": 0,
    }


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_calls_per_training_step(arch, monkeypatch):
    """The plain versions stand in for the kernels on the CPU, so counting
    their calls over one loss-and-gradient step gives the launches per step
    of the card's run, which ``_per_step_calls`` derives from the structure;
    the recurrence kernels are not on the training path."""
    calls = dict.fromkeys(("flash_fwd", "flash_bwd", "rms", "rms_bwd", "rglru", "wkv6"), 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, attr, name in ((fa_ops, "flash_fwd_plain", "flash_fwd"),
                            (fa_ops, "flash_bwd_plain", "flash_bwd"),
                            (rn_ops, "rms_norm_plain", "rms"),
                            (rn_ops, "rms_norm_bwd_plain", "rms_bwd"),
                            (rg_ops, "rglru_fwd_plain", "rglru"),
                            (wk_ops, "wkv6_fwd_plain", "wkv6")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    cfg = get_smoke_config(arch).replace(**KERNELS, remat="dots", dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg.vocab_size)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = PM.loss_fn(cfg, params, batch)
    torch.autograd.grad(loss, leaves)
    assert calls == _per_step_calls(cfg)
    # at the depths the card trains (chip_smoke.py phases 18 and 19)
    depth, want = {
        "rwkv6-1.6b": (24, {"flash_fwd": 0, "flash_bwd": 0, "rms": 144, "rms_bwd": 72}),
        "recurrentgemma-9b": (4, {"flash_fwd": 4, "flash_bwd": 2, "rms": 14, "rms_bwd": 8}),
    }[arch]
    got = _per_step_calls(cfg.replace(n_layers=depth))
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_cpu(arch):
    """The launcher on the CPU through the kernel path's plain versions:
    finite losses, the EVOL timer, the tokens and steps counters."""
    settings = TrainSettings(arch=arch, smoke=True, steps=3, global_batch=2, seq_len=32,
                             report_every=0, device="cpu", attn_impl="pallas",
                             norm_impl="fused")
    sess = TimingSession()
    summary = run_training(settings, session=sess)
    assert summary["iterations"] == 3
    assert np.isfinite(summary["final_metrics"]["loss"])
    evol = sess.db.get("EVOL/trainer::train_step")
    assert evol.count == 3 and evol.seconds() > 0
    channels = evol.read_flat()
    assert channels["tokens"] == 3 * 2 * 32 and channels["steps"] == 3
    assert channels["xla_flops"] == pytest.approx(
        3 * 6.0 * PM.param_counts(get_smoke_config(arch))[1] * 2 * 32)
