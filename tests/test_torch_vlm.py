"""PyTorch port, the vlm family: the internvl2-26b smoke config (2 layers,
d_model 64, 4/2 heads of 16, 8 stub patch embeddings) against the reference
on weights bridged from its ``init_params``, inputs drawn with numpy from a
seed.

* ``forward`` with patches on the plain path (``attn_impl="chunked"``) and
  the kernel path (``"pallas"``, ``norm_impl="fused"``; the reference runs
  its interpret-mode Pallas kernels at seq 128): f32 at 2e-4, bf16 at the
  reference's serve tolerance (atol 0.15, rtol 0.05,
  ``tests/test_serve_consistency.py``).  Index j of the output is the
  position before text token j, the reference's rebasing.
* ``prefill`` behind the patch prefix (logits, K/V cache, ``pos``) and three
  ``decode_step``s.
* Incremental decode against the full ``forward`` with that rebasing: the
  prefill's logits align with index ``S_PROMPT``.
* ``loss_fn``: loss, ``ce``, ``z_loss`` and every gradient leaf against
  ``jax.value_and_grad`` at seq 128; three AdamW steps of
  ``make_train_step`` against a JAX loop of the reference's pieces.
* ``ServeSession`` against the JAX engine, both prefilling behind zero
  patches, with a mid-stream admission: identical tokens and counters.
* The kernel calls of a prefill, a decode step and a training step, which
  ``chip_smoke.py`` phases 22 and 23 hold the card's counters to.
* The parameter tree crossing bit-exactly, ``param_counts`` at the
  published width (19,862,722,560 total, 18,723,969,024 active), and the
  launchers on the CPU.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import clocks as jax_clocks
from repro.core.timers import timer_db as jax_timer_db
from repro.data import SyntheticConfig as JaxSynthConfig, SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state, warmup_cosine as jax_warmup_cosine
from repro.serving import Request as JaxRequest, ServeSession as JaxServeSession
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import clocks as pt_clocks
from repro_torch.core.timers import timer_db as pt_timer_db
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.serve import run_serving
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainSettings, run_training
from repro_torch.models import model as PM
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serving import Request, ServeSession
from repro_torch.serving.engine import prefill_batch
from repro_torch.timing import TimingSession

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internvl2-26b"
KERNELS = dict(attn_impl="pallas", norm_impl="fused")
PLAIN = dict(attn_impl="chunked", norm_impl="ref")
SEQ, BATCH, DECODE_STEPS = 128, 2, 3
SCOPES = ("serve", "serve/admit", "serve/prefill", "serve/decode")
COUNTERS = ("serve/queued", "serve/admitted", "serve/shed", "serve/tokens",
            "serve/kv_alloc_blocks", "serve/kv_freed_blocks")
# (prompt_len, max_new): request 0 finishes early, so request 2 is admitted
# mid-stream next to request 1, at a different position
PLANS = [(24, 3), (20, 8), (12, 5)]

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


def _configs(dtype="float32", impl=KERNELS):
    over = dict(impl, dtype=dtype)
    return jax_smoke_config(ARCH).replace(**over), get_smoke_config(ARCH).replace(**over)


def _params(cfg_j):
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    return params_j, to_torch(jax.tree.map(np.asarray, params_j))


def _close(got, ref, dtype):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    atol, rtol = (2e-4, 2e-4) if dtype == "float32" else (0.15, 0.05)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _inputs(cfg, n_tokens, seed=1):
    """(jax batch, torch batch): tokens and 0.02 x N(0, 1) patch embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, n_tokens), dtype=np.int32)
    patches = (0.02 * rng.standard_normal((BATCH, cfg.n_vision_patches, cfg.d_model))
               ).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(tokens), "patch_embeds": torch.from_numpy(patches)})


def _train_batch(vocab, step=0):
    """A reference copy-task batch with its patch embeddings, as jax and torch."""
    cfg_j = jax_smoke_config(ARCH)
    b = JaxSyntheticLM(JaxSynthConfig(vocab, SEQ, BATCH, mode="copy", seed=3),
                       arch=cfg_j).batch_at(step)
    assert b["patch_embeds"].shape == (BATCH, cfg_j.n_vision_patches, cfg_j.d_model)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [PLAIN, KERNELS], ids=["chunked", "pallas"])
def test_forward_matches_jax(dtype, impl):
    cfg_j, cfg_t = _configs(dtype, impl)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _inputs(cfg_j, SEQ)
    logits_j, _ = JM.forward(cfg_j, params_j, batch_j)
    logits_t = PM.forward(cfg_t, params_t, batch_t)
    assert logits_t.shape == (BATCH, SEQ, cfg_t.padded_vocab) == tuple(logits_j.shape)
    _close(logits_t, logits_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_jax(dtype):
    """Prefill behind the patches fills positions 0..n_prefix+SEQ-1 of the
    cache; three decode steps go on from there, without a prefix."""
    cfg_j, cfg_t = _configs(dtype)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _inputs(cfg_j, SEQ + DECODE_STEPS)
    n_prefix = cfg_t.n_vision_patches
    prompt_j = dict(batch_j, tokens=batch_j["tokens"][:, :SEQ])
    prompt_t = dict(batch_t, tokens=batch_t["tokens"][:, :SEQ])
    max_seq = n_prefix + SEQ + DECODE_STEPS + 4
    cache_j, last_j = JM.prefill(cfg_j, params_j, prompt_j, JM.init_cache(cfg_j, BATCH, max_seq))
    cache_t, last_t = PM.prefill(cfg_t, params_t, prompt_t,
                                 PM.init_cache(cfg_t, BATCH, max_seq, device="cpu"))
    _close(last_t, last_j, dtype)
    pos_j = np.asarray(cache_j["pos"]).tolist()
    assert cache_t["pos"].tolist() == [n_prefix + SEQ] * BATCH == pos_j
    for kv in ("k", "v"):
        _close(cache_t["scan"][0][kv], cache_j["scan"][0][kv], dtype)
    tokens = batch_t["tokens"].numpy()
    for t in range(SEQ, SEQ + DECODE_STEPS):
        step = tokens[:, t : t + 1]
        cache_j, lg_j = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(step))
        cache_t, lg_t = PM.decode_step(cfg_t, params_t, cache_t, torch.from_numpy(step))
        _close(lg_t, lg_j, dtype)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))


def test_incremental_decode_matches_full_forward():
    """The port against itself with the reference's rebasing
    (``tests/test_serve_consistency.py``): index j of ``forward`` is the
    position before text token j, so the logits of a prefill over tokens
    0..S_PROMPT-1 and of each decode step after it are indices S_PROMPT..;
    and index 0 is the last patch's position."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", **KERNELS)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    s_prompt, s_decode = 32, 6
    total = s_prompt + s_decode
    _, batch = _inputs(cfg, total, seed=7)
    full = PM.forward(cfg, params, batch)
    n_prefix = cfg.n_vision_patches
    cache = PM.init_cache(cfg, BATCH, n_prefix + total + 2, device="cpu")
    cache, logits = PM.prefill(cfg, params, dict(batch, tokens=batch["tokens"][:, :s_prompt]),
                               cache)
    inc = [logits]
    for t in range(s_prompt, total - 1):
        cache, logits = PM.decode_step(cfg, params, cache, batch["tokens"][:, t : t + 1])
        inc.append(logits)
    inc = torch.stack(inc, dim=1)
    np.testing.assert_allclose(inc.numpy(), full[:, s_prompt:total].detach().numpy(),
                               atol=2e-4, rtol=2e-4)
    # index 0: the stack over the patches alone, read at the last one
    _, first = PM.prefill(cfg, params, dict(batch, tokens=batch["tokens"][:, :0]),
                          PM.init_cache(cfg, BATCH, n_prefix + 2, device="cpu"))
    np.testing.assert_allclose(first.numpy(), full[:, 0].detach().numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """The loss scores the text positions against ``targets`` (tokens
    shifted by one): the position that has seen text tokens 0..j-1 is scored
    on token j+1, as the reference's is."""
    cfg_j, cfg_t = _configs(dtype)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _train_batch(cfg_j.vocab_size)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True)(params_j)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params_t)]
    loss_t, metrics_t = PM.loss_fn(cfg_t, params_t, batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    _close(loss_t, loss_j, dtype)
    for key in ("ce", "z_loss", "tokens"):
        _close(metrics_t[key], metrics_j[key], dtype)
    assert float(metrics_t["aux"]) == 0.0  # no experts
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for g_t, g_j, p in zip(grads_t, flat_j, leaves):
        assert g_t.dtype == p.dtype and g_t.shape == tuple(g_j.shape)
        assert bool(torch.isfinite(g_t).all()) and float(g_t.abs().max()) > 0
        _close(g_t, g_j, dtype)


def test_three_train_steps_match_jax_loop():
    """``make_train_step`` against a JAX loop of ``loss_fn`` +
    ``adamw_update`` + ``warmup_cosine`` in f32: the step's stats, the
    params and the optimizer state after each of three steps."""
    cfg_j, cfg_t = _configs()
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
    assert built.tokens_per_call == BATCH * SEQ  # text tokens, not the patches
    for step in range(3):
        batch_j, batch_t = _train_batch(cfg_j.vocab_size, step=step)
        params_j, opt_j, stats_j = jax_step(params_j, opt_j, batch_j)
        params_t, opt_t, stats_t = built.fn(params_t, opt_t, batch_t)
        for key in ("loss", "grad_norm", "clip_scale", "lr"):
            _close(stats_t[key], stats_j[key], "float32")
        assert int(opt_t["step"]) == int(opt_j["step"]) == step + 1
        for got, ref in ((params_t, params_j), (opt_t["m"], opt_j["m"]),
                         (opt_t["v"], opt_j["v"]), (opt_t["master"], opt_j["master"])):
            for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
                _close(g, r, "float32")


def _scope_counts(db):
    counts = {}
    for root in db.tree():
        for _, node in root.walk():
            counts[node.name] = node.count
    return {s: counts.get(s, 0) for s in SCOPES}


def _serve(engine, make_request, requests):
    handles = [engine.submit(make_request(rid, list(prompt), max_new_tokens=max_new))
               for rid, (prompt, max_new) in enumerate(requests)]
    engine.run_until_idle()
    return handles


def test_serve_session_matches_jax_engine():
    """f32 on the kernel path: both engines prefill each request behind the
    zero patch prefix, and the slots' cache rows hold it (max_seq counts
    it), through a mid-stream admission."""
    cfg_j, cfg_t = _configs()
    params_j, params_t = _params(cfg_j)
    rng = np.random.default_rng(3)
    requests = [([int(t) for t in rng.integers(0, cfg_j.vocab_size, plen)], max_new)
                for plen, max_new in PLANS]
    max_seq = cfg_t.n_vision_patches + 36

    before_j = jax_clocks.counter_values(COUNTERS)
    engine_j = JaxServeSession(cfg_j, params_j, n_slots=2, max_seq=max_seq)
    handles_j = _serve(engine_j, JaxRequest, requests)
    delta_j = np.subtract(jax_clocks.counter_values(COUNTERS), before_j)

    before_t = pt_clocks.counter_values(COUNTERS)
    engine_t = ServeSession(cfg_t, params_t, n_slots=2, max_seq=max_seq, device="cpu")
    handles_t = _serve(engine_t, Request, requests)
    delta_t = np.subtract(pt_clocks.counter_values(COUNTERS), before_t)

    assert [h.result().tokens for h in handles_t] == [h.result().tokens for h in handles_j]
    assert not any(h.result().truncated for h in handles_t)
    r1, r2 = handles_t[1].result(), handles_t[2].result()
    assert r1.admitted_at < r2.admitted_at < r1.finished_at  # really mid-stream
    assert _scope_counts(pt_timer_db()) == _scope_counts(jax_timer_db())
    assert dict(zip(COUNTERS, delta_t)) == dict(zip(COUNTERS, delta_j))
    stats_t, stats_j = engine_t.stats(), engine_j.stats()
    for key in ("completed", "steps", "tokens", "kv_high_water_blocks", "max_active"):
        assert stats_t[key] == stats_j[key], key
    batch = prefill_batch(cfg_t, requests[0][0], "cpu")
    assert batch["patch_embeds"].shape == (1, cfg_t.n_vision_patches, cfg_t.d_model)
    assert batch["patch_embeds"].dtype == torch.bfloat16 and not batch["patch_embeds"].any()


def test_kernel_calls_per_prefill_decode_and_training_step(monkeypatch):
    """The plain versions stand in for the kernels on the CPU, so counting
    their calls gives the launches of the card's run: a prefill launches one
    flash forward and two RMSNorms a layer (the prefix changes the length,
    not the count), a decode step two RMSNorms a layer; a training step
    under remat "dots" ``chip_smoke._per_step_launches`` (one
    ``flash_bwd_plain`` call stands for one dq and one dkv launch)."""
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
    cfg = get_smoke_config(ARCH).replace(remat="dots", dtype="float32", **KERNELS)
    n = cfg.n_layers
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = prefill_batch(cfg, list(range(10)), "cpu")
    cache, _ = PM.prefill(cfg, params, batch,
                          PM.init_cache(cfg, 1, cfg.n_vision_patches + 16, device="cpu"))
    assert calls == {"flash_fwd": n, "flash_bwd": 0, "rms": 2 * n, "rms_bwd": 0}
    PM.decode_step(cfg, params, cache, torch.zeros((1, 1), dtype=torch.int32))
    assert calls == {"flash_fwd": n, "flash_bwd": 0, "rms": 4 * n, "rms_bwd": 0}
    # phase 22's counts at the published depth
    full = get_config(ARCH)
    assert chip_smoke.VLM_SHAPE == (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                                    full.resolved_head_dim, full.vocab_size, full.window)
    assert chip_smoke.VLM_PATCHES == full.n_vision_patches

    calls.update(dict.fromkeys(calls, 0))
    _, train = _train_batch(cfg.vocab_size)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = PM.loss_fn(cfg, params, train)
    torch.autograd.grad(loss, leaves)
    want = chip_smoke._per_step_launches(cfg)
    assert {"flash_fwd": calls["flash_fwd"], "flash_bwd_dq": calls["flash_bwd"],
            "flash_bwd_dkv": calls["flash_bwd"], "rmsnorm_fwd": calls["rms"],
            "rmsnorm_bwd": calls["rms_bwd"], "rglru_fwd": 0, "wkv6_fwd": 0} == want
    # at the depth the card trains (phase 23): 8 / 4 / 4 / 16 / 8
    assert chip_smoke._per_step_launches(
        cfg.replace(n_layers=chip_smoke.VLM_TRAIN_LAYERS)) == chip_smoke.MOE_TRAIN_PER_STEP


def test_param_tree_crosses_bit_exactly_and_counts_match():
    """The reference's bf16 param tree through ``to_torch`` and back is the
    same bits, keys, shapes and dtypes as the port's own tree; the counts
    equal the reference's at both widths (at the published width 19.86 B
    parameters: 39.7 GB in bf16)."""
    cfg_j, cfg_t = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert cfg_t.dtype == "bfloat16"
    params_j = jax.tree.map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    back = to_numpy(to_torch(params_j))
    flat_j, tree_j = jax.tree.flatten(params_j)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_b == tree_j
    for a, b in zip(flat_b, flat_j):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    own = to_numpy(PM.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu"))
    shapes = lambda tree: jax.tree.map(lambda a: (a.shape, a.dtype.name), tree)  # noqa: E731
    assert shapes(own) == shapes(params_j)
    assert PM.param_counts(cfg_t) == JM.param_counts(cfg_j)
    assert PM.param_counts(get_config(ARCH)) == JM.param_counts(jax_config(ARCH)) == (
        19_862_722_560, 18_723_969_024)


def test_launchers_serve_and_train_on_the_cpu():
    """``run_serving`` sizes each slot for the prefix, so no prompt is
    truncated; ``run_training`` takes a step on the patch batches."""
    engine = run_serving(ARCH, 3, [20, 12], 4, n_slots=2, device="cpu", **KERNELS)
    cfg = engine.cfg
    assert engine.max_seq == cfg.n_vision_patches + 20 + 4 + 8
    results = engine.completed
    assert len(results) == 3 and all(len(r.tokens) == 4 and not r.truncated for r in results)
    summary = run_training(TrainSettings(arch=ARCH, device="cpu", steps=1, global_batch=2,
                                         seq_len=32, report_every=0, **KERNELS),
                           session=TimingSession())
    assert summary["iterations"] == 1 and np.isfinite(summary["final_metrics"]["loss"])
