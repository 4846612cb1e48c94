"""PyTorch port, the encdec family: the seamless-m4t-large-v2 smoke config
(2 encoder + 2 decoder layers, d_model 64, 4/4 heads of 16) against the
reference on weights bridged from its ``init_params``, inputs drawn with
numpy from a seed.  At seq 128 the reference runs its interpret-mode Pallas
flash kernels (as ``tests/test_kernels_flash.py`` does); at a ragged length
its ``chunked_attention`` fallback.

* ``_encode`` alone (f32 at 2e-4, bf16 at the repo's 3e-2).
* ``forward`` from random source frames on the plain path
  (``attn_impl="chunked"``) and the kernel path (``"pallas"``,
  ``norm_impl="fused"``): f32 at 2e-4, bf16 at the reference's serve
  tolerance (atol 0.15, rtol 0.05, ``tests/test_serve_consistency.py``).
* ``prefill`` and four ``decode_step``s: logits, and the port's in-place
  cross K/V rows ``[:, :T]`` against the reference's T-long ones.
* Two requests from random frames of different lengths, each prefilled
  alone, spliced into one 2-slot cache and decoded together: each row equals
  the reference's batch-1 decode (the per-row source length ``xlen``).
* ``loss_fn`` and every gradient leaf (the encoder's, ``enc_final_norm``
  and the cross-attention's included) against ``jax.value_and_grad``; the
  same gradients under every remat policy.
* ``ServeSession`` token-identical to the reference's batch-1 prefill and
  decode per request, across a mid-stream admission (the reference's engine
  cannot splice an encdec cache: its prefill returns cross K/V at the
  source length, not at ``max_seq``).
* The kernel calls of a prefill, a decode step and a training step, which
  ``chip_smoke.py`` phases 24 and 25 hold the card's counters to; the
  parameter tree crossing bit-exactly and ``param_counts`` at the published
  width; the launchers on the CPU.
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
from repro.data import SyntheticConfig as JaxSynthConfig, SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import TrainSettings, run_training
from repro_torch.models import model as PM
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serving import Request, ServeSession
from repro_torch.serving.batching import make_cache_splicer
from repro_torch.serving.engine import prefill_batch
from repro_torch.timing import TimingSession

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-large-v2"
KERNELS = dict(attn_impl="pallas", norm_impl="fused")
PLAIN = dict(attn_impl="chunked", norm_impl="ref")
SEQ, BATCH, DECODE_STEPS = 128, 2, 4
# (prompt_len, max_new): request 0 finishes early, so request 2 is admitted
# mid-stream next to request 1, at a different position
PLANS = [(12, 3), (20, 8), (12, 5)]

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


def _close(got, ref, dtype, tol=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    atol, rtol = tol or ((2e-4, 2e-4) if dtype == "float32" else (0.15, 0.05))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _frames(rng, cfg, batch, n):
    """Random source frames (batch, n, d_model), N(0, 1): the encoder's
    input scale matters to its residual stream, its output is normed."""
    return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)


def _inputs(cfg, n_tokens, n_frames=None, seed=1):
    """(jax batch, torch batch): tokens and random source frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, n_tokens), dtype=np.int32)
    frames = _frames(rng, cfg, BATCH, n_frames or n_tokens)
    return ({"tokens": jnp.asarray(tokens), "src_frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens), "src_frames": torch.from_numpy(frames)})


def _train_batch(vocab, step=0):
    """A reference copy-task batch with its source frames, as jax and torch."""
    cfg_j = jax_smoke_config(ARCH)
    b = JaxSyntheticLM(JaxSynthConfig(vocab, SEQ, BATCH, mode="copy", seed=3),
                       arch=cfg_j).batch_at(step)
    assert b["src_frames"].shape == (BATCH, SEQ, cfg_j.d_model)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [PLAIN, KERNELS], ids=["chunked", "pallas"])
def test_encode_matches_jax(dtype, impl):
    """The encoder alone: its stack not causal, rotary over source
    positions, then the unfused final norm."""
    cfg_j, cfg_t = _configs(dtype, impl)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _inputs(cfg_j, SEQ)
    enc_j = JM._encode(cfg_j, params_j, batch_j)
    enc_t = PM._encode(cfg_t, params_t, batch_t, training=True)
    assert enc_t.shape == (BATCH, SEQ, cfg_t.d_model) and enc_t.dtype == params_t["embed"][
        "tokens"].dtype
    _close(enc_t, enc_j, dtype, None if dtype == "float32" else (3e-2, 3e-2))
    # prefill's encoder (no remat, no aux loss) gives the same bits as training's
    assert torch.equal(PM._encode(cfg_t, params_t, batch_t, training=False), enc_t)


def test_prefill_encoder_makes_no_aux_loss(monkeypatch):
    """In prefill the encoder's blocks create no f32 aux zeros and keep no
    K/V: the serving path pays no device operation for them."""
    cfg_j, cfg_t = _configs("bfloat16", KERNELS)
    _, params_t = _params(cfg_j)
    _, batch_t = _inputs(cfg_j, SEQ)
    zeros, made = torch.zeros, []

    def spy(*args, **kwargs):
        out = zeros(*args, **kwargs)
        made.append(out.shape)
        return out

    monkeypatch.setattr(torch, "zeros", spy)
    PM._encode(cfg_t, params_t, batch_t, training=True)
    assert made.count(torch.Size([])) >= cfg_t.n_enc_layers
    made.clear()
    PM._encode(cfg_t, params_t, batch_t, training=False)
    assert made == []
    src = batch_t["src_frames"].to(torch.bfloat16)
    _, caches, aux = PM._apply_stack(cfg_t, params_t, src, rope=PM._rope(cfg_t, SEQ, "cpu"),
                                     mode="prefill", encoder=True)
    assert caches is None and aux is None


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


def test_forward_reads_the_source():
    """Other source frames give other logits: the decoder attends to the
    encoder output (the engine's zero frames would hide a cross-attention
    that read nothing)."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", **KERNELS)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _inputs(cfg, 32)
    logits = PM.forward(cfg, params, batch)
    moved = PM.forward(cfg, params, dict(batch, src_frames=batch["src_frames"].flip(1)))
    assert float((moved - logits).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_frames", [SEQ, 100], ids=["S=T", "S!=T"])
def test_prefill_decode_match_jax(dtype, n_frames):
    """Prefill writes each decoder layer's cross K/V into rows 0..T-1 of
    the ``max_seq``-long cache and T into ``xlen``; the reference returns a
    T-long cross cache.  Four decode steps go on from there."""
    cfg_j, cfg_t = _configs(dtype)
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _inputs(cfg_j, SEQ + DECODE_STEPS, n_frames)
    prompt_j = dict(batch_j, tokens=batch_j["tokens"][:, :SEQ])
    prompt_t = dict(batch_t, tokens=batch_t["tokens"][:, :SEQ])
    max_seq = SEQ + DECODE_STEPS + 4
    cache_j, last_j = JM.prefill(cfg_j, params_j, prompt_j, JM.init_cache(cfg_j, BATCH, max_seq))
    cache_t, last_t = PM.prefill(cfg_t, params_t, prompt_t,
                                 PM.init_cache(cfg_t, BATCH, max_seq, device="cpu"))
    _close(last_t, last_j, dtype)
    assert cache_t["pos"].tolist() == [SEQ] * BATCH == np.asarray(cache_j["pos"]).tolist()
    layer_t, layer_j = cache_t["scan"][0], cache_j["scan"][0]
    assert layer_j["xk"].shape[2] == n_frames and layer_t["xk"].shape[2] == max_seq
    assert layer_t["xlen"].tolist() == [[n_frames] * BATCH] * cfg_t.n_layers
    for kv in ("xk", "xv"):
        _close(layer_t[kv][:, :, :n_frames], layer_j[kv], dtype)
    for kv in ("k", "v"):
        _close(layer_t["self"][kv], layer_j["self"][kv], dtype)
    tokens = batch_t["tokens"].numpy()
    for t in range(SEQ, SEQ + DECODE_STEPS):
        step = tokens[:, t : t + 1]
        cache_j, lg_j = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(step))
        cache_t, lg_t = PM.decode_step(cfg_t, params_t, cache_t, torch.from_numpy(step))
        _close(lg_t, lg_j, dtype)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))


def _reference_decode(cfg_j, params_j, tokens, frames, n_prompt, max_seq):
    """Logits of a batch-1 prefill over ``tokens[:n_prompt]`` from ``frames``,
    then of one decode step per remaining token, in the reference."""
    cache, logits = JM.prefill(cfg_j, params_j, {"tokens": jnp.asarray(tokens[None, :n_prompt]),
                                                 "src_frames": jnp.asarray(frames[None])},
                               JM.init_cache(cfg_j, 1, max_seq))
    out = [np.asarray(logits[0])]
    for t in range(n_prompt, len(tokens)):
        cache, logits = JM.decode_step(cfg_j, params_j, cache, jnp.asarray(tokens[None, t : t + 1]))
        out.append(np.asarray(logits[0]))
    return out


def test_spliced_rows_of_different_source_lengths_decode_as_alone():
    """Two requests from random frames of different lengths (and prompts of
    different lengths), each prefilled alone into a 1-row cache and spliced
    by the engine's splicer into one 2-slot cache, then decoded together:
    each row's logits equal the reference's batch-1 decode.  Without the
    per-row ``xlen`` the shorter source's row would attend to the cross K/V
    rows past its end."""
    cfg_j, cfg_t = _configs()
    params_j, params_t = _params(cfg_j)
    rng = np.random.default_rng(5)
    max_seq, steps = 48, 4
    requests = [(20, 40), (12, 9)]  # (prompt tokens, source frames)
    seqs = [rng.integers(0, cfg_j.vocab_size, n + steps, dtype=np.int32) for n, _ in requests]
    frames = [_frames(rng, cfg_j, 1, t)[0] for _, t in requests]
    want = [_reference_decode(cfg_j, params_j, s, f, n, max_seq)
            for s, f, (n, _) in zip(seqs, frames, requests)]

    splice = make_cache_splicer(cfg_t, 2, max_seq)
    cache = PM.init_cache(cfg_t, 2, max_seq, device="cpu")
    for slot, (s, f, (n, _)) in enumerate(zip(seqs, frames, requests)):
        row, logits = PM.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(s[None, :n]),
                                                   "src_frames": torch.from_numpy(f[None])},
                                 PM.init_cache(cfg_t, 1, max_seq, device="cpu"))
        _close(logits[0], want[slot][0], "float32")
        splice(cache, row, slot)
    assert cache["scan"][0]["xlen"].tolist() == [[t for _, t in requests]] * cfg_t.n_layers
    for i in range(steps):
        step = np.stack([s[n + i : n + i + 1] for s, (n, _) in zip(seqs, requests)])
        cache, logits = PM.decode_step(cfg_t, params_t, cache, torch.from_numpy(step))
        for slot in range(2):
            _close(logits[slot], want[slot][i + 1], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """Loss, ``ce``, ``z_loss`` and every gradient leaf, the encoder's (whose
    output reaches the decoder units under remat "dots"), ``enc_final_norm``
    and the cross-attention's ``wq``/``wk``/``wv``/``wo`` included."""
    cfg_j, cfg_t = _configs(dtype)
    assert cfg_t.remat == "dots"
    params_j, params_t = _params(cfg_j)
    batch_j, batch_t = _train_batch(cfg_j.vocab_size)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True)(params_j)
    names = [name for name, _ in chip_smoke._named_leaves(params_t)]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params_t)]
    loss_t, metrics_t = PM.loss_fn(cfg_t, params_t, batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    _close(loss_t, loss_j, dtype)
    for key in ("ce", "z_loss", "tokens"):
        _close(metrics_t[key], metrics_j[key], dtype)
    assert float(metrics_t["aux"]) == 0.0  # no experts
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t) == len(names)
    assert {"enc_scan/0/wq", "enc_scan/0/mlp/wo", "enc_final_norm", "scan/0/cross/wq",
            "scan/0/cross/wk", "scan/0/cross/wv", "scan/0/cross/wo"} <= set(names)
    for name, g_t, g_j, p in zip(names, grads_t, flat_j, leaves):
        assert g_t.dtype == p.dtype and g_t.shape == tuple(g_j.shape), name
        assert bool(torch.isfinite(g_t).all()) and float(g_t.abs().max()) > 0, name
        _close(g_t, g_j, dtype)


def test_grads_equal_under_every_remat_policy():
    """The decoder units close over the encoder output; under "full" and
    "dots" their non-reentrant checkpoints carry its gradient back through
    the recompute: every leaf's gradient equals the one without remat."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", **KERNELS)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _train_batch(cfg.vocab_size)
    grads = {}
    for remat in ("none", "full", "dots"):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = PM.loss_fn(cfg.replace(remat=remat), live, batch)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def _reference_tokens(cfg_j, params_j, prompt, max_new, max_seq):
    """Greedy tokens of one request served alone in the reference: exact
    batch-1 prefill from the engine's zero frames, then single-row decode
    (``tests/test_serve_consistency.py``'s ground truth)."""
    batch = {"tokens": jnp.asarray([prompt], jnp.int32),
             "src_frames": jnp.zeros((1, len(prompt), cfg_j.d_model), jnp.bfloat16)}
    cache, logits = JM.prefill(cfg_j, params_j, batch, JM.init_cache(cfg_j, 1, max_seq))
    toks = [int(jnp.argmax(logits[0, : cfg_j.vocab_size]))]
    for _ in range(max_new - 1):
        cache, logits = JM.decode_step(cfg_j, params_j, cache,
                                       jnp.asarray([[toks[-1]]], jnp.int32))
        toks.append(int(jnp.argmax(logits[0, : cfg_j.vocab_size])))
    return toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_session_matches_reference_per_request(dtype):
    """The engine's invariant against the reference: continuous batching
    (per-request prefill from zero frames, slot splicing with the cross
    cache and its length, rows at different positions) gives each request
    the tokens of the reference serving it alone, through a mid-stream
    admission."""
    cfg_j, cfg_t = _configs(dtype)
    params_j, params_t = _params(cfg_j)
    rng = np.random.default_rng(3)
    requests = [([int(t) for t in rng.integers(0, cfg_j.vocab_size, plen)], max_new)
                for plen, max_new in PLANS]
    max_seq = 48
    want = [_reference_tokens(cfg_j, params_j, prompt, max_new, max_seq)
            for prompt, max_new in requests]
    engine = ServeSession(cfg_t, params_t, n_slots=2, max_seq=max_seq, control=False,
                          device="cpu")
    handles = [engine.submit(Request(rid, list(prompt), max_new_tokens=max_new))
               for rid, (prompt, max_new) in enumerate(requests)]
    engine.run_until_idle()
    assert [h.result().tokens for h in handles] == want
    r1, r2 = handles[1].result(), handles[2].result()
    assert r1.admitted_at < r2.admitted_at < r1.finished_at  # really mid-stream
    batch = prefill_batch(cfg_t, requests[0][0], "cpu")
    frames = batch["src_frames"]
    assert frames.shape == (1, len(requests[0][0]), cfg_t.d_model)
    assert frames.dtype == torch.bfloat16 and not frames.any()


def test_kernel_calls_per_prefill_decode_and_training_step(monkeypatch):
    """The plain versions stand in for the kernels on the CPU, so counting
    their calls gives the launches of the card's run: a prefill launches a
    flash forward for each encoder layer and two for each decoder layer
    (self- and cross-attention), two RMSNorms an encoder layer and three a
    decoder layer; a decode step three RMSNorms a decoder layer and no
    flash; a training step under remat "dots" ``chip_smoke._per_step_launches``
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
    cfg = get_smoke_config(ARCH).replace(remat="dots", dtype="float32", **KERNELS)
    n, e = cfg.n_layers, cfg.n_enc_layers
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = prefill_batch(cfg, list(range(10)), "cpu")
    cache, _ = PM.prefill(cfg, params, batch, PM.init_cache(cfg, 1, 16, device="cpu"))
    assert calls == {"flash_fwd": e + 2 * n, "flash_bwd": 0, "rms": 2 * e + 3 * n, "rms_bwd": 0}
    PM.decode_step(cfg, params, cache, torch.zeros((1, 1), dtype=torch.int32))
    assert calls == {"flash_fwd": e + 2 * n, "flash_bwd": 0, "rms": 2 * e + 6 * n, "rms_bwd": 0}
    # phase 24's counts at the published depth
    full = get_config(ARCH)
    assert chip_smoke.ENCDEC_SHAPE == (full.n_layers, full.d_model, full.n_heads,
                                       full.n_kv_heads, full.resolved_head_dim, full.vocab_size,
                                       full.window)
    assert chip_smoke.ENCDEC_ENC_LAYERS == full.n_enc_layers
    assert chip_smoke.ENCDEC_PER_PREFILL == {"flash_fwd": full.n_enc_layers + 2 * full.n_layers,
                                             "rmsnorm_fwd": 2 * full.n_enc_layers}
    assert chip_smoke.ENCDEC_PER_CALL == {"rmsnorm_fwd": 3 * full.n_layers}

    calls.update(dict.fromkeys(calls, 0))
    _, train = _train_batch(cfg.vocab_size)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = PM.loss_fn(cfg, params, train)
    torch.autograd.grad(loss, leaves)
    want = chip_smoke._per_step_launches(cfg)
    assert {"flash_fwd": calls["flash_fwd"], "flash_bwd_dq": calls["flash_bwd"],
            "flash_bwd_dkv": calls["flash_bwd"], "rmsnorm_fwd": calls["rms"],
            "rmsnorm_bwd": calls["rms_bwd"], "rglru_fwd": 0, "wkv6_fwd": 0} == want
    # phase 25 at the published depth: 144 / 72 / 72 / 240 / 120
    assert chip_smoke._per_step_launches(
        full.replace(remat="dots")) == chip_smoke.ENCDEC_TRAIN_PER_STEP


def test_plain_kernels_swaps_every_wrapper_and_restores_it():
    """Phase 25's anchor path: inside ``chip_smoke._plain_kernels`` each
    flash and RMSNorm wrapper the model calls is its plain version (no
    launch, no count), and the wrappers come back after it, also when the
    body raises; on the CPU the wrappers run those plain versions anyway, so
    a loss-and-gradient step gives the same bits inside and outside."""
    names = [(fa_ops, "flash_fwd", "flash_fwd_plain"),
             (fa_ops, "flash_bwd_dq", "flash_bwd_dq_plain"),
             (fa_ops, "flash_bwd_dkv", "flash_bwd_dkv_plain"),
             (rn_ops, "rms_norm_fwd", "rms_norm_plain"),
             (rn_ops, "rms_norm_bwd", "rms_norm_bwd_plain")]
    wrappers = [getattr(mod, name) for mod, name, _ in names]
    cfg = get_smoke_config(ARCH).replace(remat="dots", dtype="bfloat16", **KERNELS)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _train_batch(cfg.vocab_size)
    outside = chip_smoke._loss_and_grads(torch, cfg, params, batch)
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke._plain_kernels():
            assert all(getattr(mod, name) is getattr(mod, plain) for mod, name, plain in names)
            inside = chip_smoke._loss_and_grads(torch, cfg, params, batch)
            raise RuntimeError("inside")
    assert [getattr(mod, name) for mod, name, _ in names] == wrappers
    assert inside[:2] == outside[:2]
    assert all(torch.equal(a, b) for a, b in zip(inside[2], outside[2]))


def test_param_tree_crosses_bit_exactly_and_counts_match():
    """The reference's bf16 param tree (``enc_scan``, ``enc_final_norm``,
    the decoder's ``self``/``cross`` subtrees) through ``to_torch`` and back
    is the same bits, keys, shapes and dtypes as the port's own tree; the
    counts equal the reference's at both widths (at the published width
    2.03 B parameters: 4.07 GB in bf16)."""
    cfg_j, cfg_t = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert cfg_t.dtype == "bfloat16"
    params_j = jax.tree.map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    assert {"enc_scan", "enc_final_norm"} <= set(params_j)
    assert set(params_j["scan"][0]) == {"self", "cross", "ln2", "mlp"}
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
        2_034_886_656, 1_510_074_368)


def test_launchers_serve_and_train_on_the_cpu():
    """``run_serving`` encodes each prompt's zero frames and serves every
    request in full; ``run_training`` takes steps on batches with source
    frames, through the kernels' plain versions."""
    engine = run_serving(ARCH, 3, [20, 12], 4, n_slots=2, device="cpu", **KERNELS)
    assert engine.cfg.family == "encdec"
    results = engine.completed
    assert len(results) == 3 and all(len(r.tokens) == 4 and not r.truncated for r in results)
    summary = run_training(TrainSettings(arch=ARCH, device="cpu", steps=2, global_batch=2,
                                         seq_len=32, report_every=0, **KERNELS),
                           session=TimingSession())
    assert summary["iterations"] == 2 and np.isfinite(summary["final_metrics"]["loss"])
