"""PyTorch port, training of the MoE family: the moonshot-v1-16b-a3b and
kimi-k2-1t-a32b smoke configs with the kernel settings (``attn_impl="pallas"``,
``norm_impl="fused"``) against the reference on weights bridged from its
``init_params``.

* ``loss_fn``'s value, its ``ce``, ``aux`` and ``z_loss`` metrics and every
  gradient leaf, the router's included, against ``jax.value_and_grad`` of
  the reference's ``loss_fn``: in f32 with each path routing on its own and
  every top-k choice equal, in bf16 with the port replaying the reference's
  choices (indices only, layer by layer), so that the comparison measures
  the backward and not a near-tie that the two rounding orders break
  differently;
* ``aux`` alone at 1e-5, and ``aux_coef=0`` leaving exactly CE plus z-loss;
* three AdamW steps of ``make_train_step`` against a JAX loop of the
  reference's ``loss_fn`` + ``adamw_update`` + ``warmup_cosine`` (f32);
* the kernel calls of one step under ``remat="dots"``: ``chip_smoke.py``'s
  ``_per_step_launches``, which phase 21 holds the card's counters to;
* ``remat="dots"`` against ``"none"``: the recompute routes as the forward
  did, so loss and gradients agree;
* ``run_training(device="cpu")`` with a checkpoint and a resume whose later
  losses equal the uninterrupted run's.

The reference's choices are read in its own differentiated call: a spy on
``jax.lax.top_k`` hands each layer's indices to ``jax.debug.callback``, which
runs once per layer in the forward and once more in the remat recompute, in
reverse layer order.  Sequence 128: the reference's Pallas flash kernels
tile it, so it differentiates its interpret-mode ``flash_bwd_dq``/
``flash_bwd_dkv`` and the port its ``autograd.Function`` (the plain versions
on CPU tensors).  Tolerances as ``test_torch_train_hybrid_ssm.py``: f32 2e-4,
bf16 atol 0.15 / rtol 0.05 (``tests/test_serve_consistency.py:143``).
"""

import importlib.util
import json
import os
from pathlib import Path

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
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainSettings, run_training
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.timing import TimingSession

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
SEQ, BATCH = 128, 2

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's), and run torch on one
    CPU thread: the shapes are tiny."""
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
    over = dict(attn_impl="pallas", norm_impl="fused", dtype=dtype)
    return jax_smoke_config(arch).replace(**over), get_smoke_config(arch).replace(**over)


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


def _router_keys(cfg, params):
    """The ``_routing_tap`` key of each layer, in layer order: the bits of
    its router weight (a unit's slice of the stacked leaf, then the tail)."""
    n_scan, pattern, _ = PM._split_stack(cfg)
    keys = [chip_smoke._router_key(torch, params["scan"][j]["moe"]["router"][i])
            for i in range(n_scan) for j in range(len(pattern))]
    return keys + [chip_smoke._router_key(torch, p["moe"]["router"]) for p in params["tail"]]


def _jax_value_and_grad(monkeypatch, cfg_j, params_j, batch_j):
    """``jax.value_and_grad`` of the reference's loss, and each layer's top-k
    choices in that call, in layer order."""
    top_k = jax.lax.top_k
    seen = []

    def spy(a, k):
        out = top_k(a, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True)(params_j)
    jax.block_until_ready(grads)
    monkeypatch.undo()
    n = cfg_j.n_layers
    # the forward, then the remat recompute in reverse layer order
    assert len(seen) == 2 * n
    for a, b in zip(seen[n:], seen[n - 1::-1]):
        np.testing.assert_array_equal(a, b)
    return (loss, metrics), grads, seen[:n]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(monkeypatch, arch, dtype):
    cfg_j, cfg_t = _configs(arch, dtype)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _batch(cfg_j.vocab_size)
    (loss_j, metrics_j), grads_j, chosen_j = _jax_value_and_grad(
        monkeypatch, cfg_j, params_j, batch_j)
    keys = _router_keys(cfg_t, params_t)
    replay = ({key: torch.from_numpy(c).long() for key, c in zip(keys, chosen_j)}
              if dtype == "bfloat16" else None)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params_t)]
    with chip_smoke._routing_tap(torch, replay) as taps:
        loss_t, metrics_t = PM.loss_fn(cfg_t, params_t, batch_t)
        grads_t = torch.autograd.grad(loss_t, leaves)
    assert list(taps) == keys
    for key, c in zip(keys, chosen_j):
        np.testing.assert_array_equal(taps[key][0].numpy(), c)  # replayed in bf16
    _close(loss_t, loss_j, dtype)
    for key in ("ce", "aux", "z_loss", "tokens"):
        _close(metrics_t[key], metrics_j[key], dtype)
    assert float(metrics_t["aux"].detach()) > 0
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for g_t, g_j, p in zip(grads_t, flat_j, leaves):
        assert g_t.dtype == p.dtype and g_t.shape == tuple(g_j.shape)
        assert bool(torch.isfinite(g_t).all())
        _close(g_t, g_j, dtype)
    routers = [g for g, p in zip(grads_t, leaves) if p.dtype == torch.float32 and p.dim() == 3]
    assert routers and all(g.abs().max() > 0 for g in routers)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_matches_jax_and_aux_coef_zero_leaves_ce_plus_z(arch):
    """The summed load-balancing loss over the layers against the
    reference's at 1e-5 (f32, both routing on their own), and the loss's
    composition: ``ce + z_loss + aux_coef * aux``, exactly CE plus z-loss
    at ``aux_coef=0``."""
    cfg_j, cfg_t = _configs(arch)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _batch(cfg_j.vocab_size)
    _, metrics_j = JM.loss_fn(cfg_j, params_j, batch_j)
    loss, metrics = PM.loss_fn(cfg_t, params_t, batch_t)
    np.testing.assert_allclose(float(metrics["aux"]), float(metrics_j["aux"]),
                               atol=1e-5, rtol=1e-5)
    # each MoE layer's aux is at least top_k (E x sum_e f_e p_e, sum_e f_e = top_k)
    assert float(metrics["aux"]) > 0
    assert torch.equal(loss, metrics["ce"] + metrics["z_loss"] + 0.01 * metrics["aux"])
    loss0, metrics0 = PM.loss_fn(cfg_t, params_t, batch_t, aux_coef=0.0)
    assert torch.equal(metrics0["aux"], metrics["aux"])
    assert torch.equal(loss0, metrics0["ce"] + metrics0["z_loss"])
    assert float(loss0) < float(loss)


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
        for key in ("loss", "aux", "grad_norm", "clip_scale", "lr"):
            _close(stats_t[key], stats_j[key], "float32")
        assert int(opt_t["step"]) == int(opt_j["step"]) == step + 1
        for got, ref in ((params_t, params_j), (opt_t["m"], opt_j["m"]),
                         (opt_t["v"], opt_j["v"]), (opt_t["master"], opt_j["master"])):
            for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
                _close(g, r, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_calls_per_training_step(arch, monkeypatch):
    """The plain versions stand in for the kernels on the CPU, so counting
    their calls over one loss-and-gradient step gives the launches per step
    of the card's run; they must equal ``chip_smoke._per_step_launches``
    (one ``flash_bwd_plain`` call stands for one dq and one dkv launch)."""
    calls = dict.fromkeys(("flash_fwd", "flash_bwd", "rms", "rms_bwd"), 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, attr, name in ((fa_ops, "flash_fwd_plain", "flash_fwd"),
                            (fa_ops, "flash_bwd_plain", "flash_bwd"),
                            (rn_ops, "rms_norm_plain", "rms"),
                            (rn_ops, "rms_norm_bwd_plain", "rms_bwd")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    cfg = get_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused", remat="dots",
                                         dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg.vocab_size)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = PM.loss_fn(cfg, params, batch)
    torch.autograd.grad(loss, leaves)
    want = chip_smoke._per_step_launches(cfg)
    assert {"flash_fwd": calls["flash_fwd"], "flash_bwd_dq": calls["flash_bwd"],
            "flash_bwd_dkv": calls["flash_bwd"], "rmsnorm_fwd": calls["rms"],
            "rmsnorm_bwd": calls["rms_bwd"], "rglru_fwd": 0, "wkv6_fwd": 0} == want
    # at the depth the card trains (chip_smoke.py phase 21)
    assert chip_smoke._per_step_launches(
        cfg.replace(n_layers=chip_smoke.MOE_TRAIN_LAYERS)) == chip_smoke.MOE_TRAIN_PER_STEP


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recompute_routes_as_the_forward(arch, monkeypatch):
    """Under ``remat="dots"`` each layer routes twice, in the forward and in
    the backward's recompute, and must choose alike both times; the loss and
    every gradient then equal those of ``remat="none"``, which routes once."""
    route = PMoE.route
    calls = {}

    def recording(cfg, router, x, top_i=None):
        r = route(cfg, router, x, top_i)
        calls.setdefault(router.data_ptr(), []).append(r.top_i.detach())
        return r

    monkeypatch.setattr(PMoE, "route", recording)
    cfg = get_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused",
                                         dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg.vocab_size)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    out = {}
    for remat in ("dots", "none"):
        calls.clear()
        loss, metrics = PM.loss_fn(cfg.replace(remat=remat), params, batch)
        out[remat] = (loss, metrics["aux"], torch.autograd.grad(loss, leaves))
        assert len(calls) == cfg.n_layers
        for seen in calls.values():
            assert len(seen) == (2 if remat == "dots" else 1)
            assert all(torch.equal(t, seen[0]) for t in seen)
    (loss_d, aux_d, grads_d), (loss_n, aux_n, grads_n) = out["dots"], out["none"]
    torch.testing.assert_close(loss_d, loss_n)
    torch.testing.assert_close(aux_d, aux_n)
    for a, b in zip(grads_d, grads_n):
        torch.testing.assert_close(a, b)


def test_route_replays_given_choices():
    """``route(top_i=...)`` takes the given experts in place of its own top-k
    (here each token's k least likely ones), weights them by its own gates
    renormalised over them, gives the slots in token order from those
    choices, and passes the gradient to the router through those gates."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(dtype="float32")
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    router = (0.1 * torch.randn((cfg.d_model, e), generator=gen)).requires_grad_()
    own = PMoE.route(cfg, router, x)
    given = torch.topk(own.gates.detach(), k, dim=-1, largest=False).indices
    r = PMoE.route(cfg, router, x, top_i=given)
    assert torch.equal(r.top_i, given) and not torch.equal(r.top_i, own.top_i)
    picked = r.gates.gather(-1, given)
    torch.testing.assert_close(r.weights.gather(-1, given), picked / picked.sum(-1, keepdim=True))
    assert torch.equal(r.mask.sum(-1), torch.full((2, 16), k, dtype=r.mask.dtype))
    assert torch.equal(r.mask.gather(-1, given), torch.ones_like(given, dtype=r.mask.dtype))
    cap = r.token_idx.shape[-1]
    assert torch.equal(r.pos, torch.cumsum(r.mask, dim=1) - 1)
    assert torch.equal(r.keep, (r.mask == 1) & (r.pos < cap))
    (grad,) = torch.autograd.grad((r.weights * torch.arange(e)).sum(), router)
    assert grad.abs().max() > 0


def _train(tmp_path, name, **kw):
    """``run_training`` of the moonshot smoke config on the CPU; returns the
    summary and the loss of each step that ran."""
    log = tmp_path / f"{name}.jsonl"
    settings = TrainSettings(arch="moonshot-v1-16b-a3b", smoke=True, global_batch=2,
                             seq_len=32, report_every=0, device="cpu", attn_impl="pallas",
                             norm_impl="fused", lr_total_steps=6, log_path=str(log), **kw)
    summary = run_training(settings, session=TimingSession())
    with open(log) as f:
        losses = {r["iteration"]: r["extra"]["loss"] for r in map(json.loads, f)}
    return summary, losses


def test_run_training_cpu_with_checkpoint_and_resume(tmp_path):
    """The launcher trains the moonshot smoke config on the CPU: six steps
    straight through, and the same six as three that save at shutdown plus
    three restored from that checkpoint; the resumed run's losses equal the
    uninterrupted run's."""
    full, straight = _train(tmp_path, "straight", steps=6)
    assert full["iterations"] == 6 and sorted(straight) == list(range(6))
    assert all(np.isfinite(x) for x in straight.values())
    ckpt = tmp_path / "ckpt"
    _, first = _train(tmp_path, "a", steps=3, ckpt_dir=str(ckpt), ckpt_mode="fixed",
                      ckpt_every=1000)
    assert os.listdir(ckpt) == ["step_00000003"]
    resumed, rest = _train(tmp_path, "b", steps=6, ckpt_dir=str(ckpt), ckpt_mode="off")
    assert resumed["resume"]["selected_step"] == 3
    assert sorted(rest) == [3, 4, 5]
    assert {**first, **rest} == straight
