"""PyTorch port, hybrid and SSM families: the recurrentgemma-9b and rwkv6-1.6b
smoke configs against the reference on the same bridged weights.

* ``forward`` logits in f32 and bf16, the port under each ``seq_impl``
  (parallel / ref / pallas) with the plain and the kernel settings of
  attention and norm; the reference at its defaults.  Sequence 64: the
  chunked WKV-6 path, and 4x the smoke window of 16.
* ``prefill`` of a 40-token prompt (the 16-slot ring wraps), then 20
  ``decode_step``s: logits at every step and every cache leaf, ``slot_pos``
  exactly.
* The block helpers ``_causal_conv`` (with a state), ``_rglru_gates`` and
  ``_token_shift``.
* ``ServeSession`` in f32 with the kernel settings: tokens identical to the
  reference engine's, the same ``serve/*`` counters and scope counts, the
  same KV high-water mark.
* ``seq_impl="pallas"`` on CPU tensors differentiates through the kernels'
  plain versions (the refusal on the card is a ``cuda`` test).

Tolerances: f32 2e-4 (``tests/test_torch_model.py``); bf16 the reference's
own for whole-model comparisons of these families across reduction orders,
atol 0.15 / rtol 0.05 (``tests/test_serve_consistency.py:143``), with argmax
agreement above 0.9: on these random smoke weights the logits have near
ties, and the reference's own bf16 forward agrees with its f32 forward (same
weights, upcast) at only 0.945 (recurrentgemma) and 0.961 (rwkv6) of the
positions.  XLA on the CPU keeps bf16 elementwise chains in f32 inside its
fusions, where the port rounds after each op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import clocks as jax_clocks
from repro.core.timers import timer_db as jax_timer_db
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serving import Request as JaxRequest, ServeSession as JaxServeSession
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import clocks as pt_clocks
from repro_torch.core.timers import timer_db as pt_timer_db
from repro_torch.models import blocks as PB
from repro_torch.models import model as PM
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serving import Request, ServeSession

ARCHS = ("recurrentgemma-9b", "rwkv6-1.6b")
KERNELS = dict(attn_impl="pallas", norm_impl="fused")
PLAIN = dict(attn_impl="chunked", norm_impl="ref")
SEQ, BATCH = 64, 2
PROMPT, DECODE_STEPS = 40, 20


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


def _close(a, b, dtype, logits=True):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
        return
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)
    if logits:
        agree = (a.argmax(-1) == b.argmax(-1)).mean()
        assert agree > 0.9, f"argmax agreement {agree:.3f}"


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """(JAX config, JAX params, port params, tokens, JAX forward logits) —
    computed once per (arch, dtype) for every port setting."""
    cfg_j = jax_smoke_config(arch).replace(dtype=dtype)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (BATCH, SEQ), dtype=np.int32)
    logits_j, _ = JM.forward(cfg_j, params_j, {"tokens": jnp.asarray(tokens)})
    return cfg_j, params_j, params_t, tokens, np.asarray(logits_j, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_impl", ["parallel", "ref", "pallas"])
@pytest.mark.parametrize("impls", [PLAIN, KERNELS], ids=["plain", "kernels"])
def test_forward_matches_jax(arch, dtype, seq_impl, impls):
    _, _, params_t, tokens, logits_j = _reference(arch, dtype)
    cfg_t = get_smoke_config(arch).replace(dtype=dtype, seq_impl=seq_impl, **impls)
    logits_t = PM.forward(cfg_t, params_t, {"tokens": torch.from_numpy(tokens)})
    assert logits_t.shape == (BATCH, SEQ, cfg_t.padded_vocab)
    _close(logits_t.float().numpy(), logits_j, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    cfg_j, params_j, params_t, _, _ = _reference(arch, dtype)
    cfg_t = get_smoke_config(arch).replace(dtype=dtype, seq_impl="pallas", **KERNELS)
    tokens = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (BATCH, PROMPT + DECODE_STEPS), dtype=np.int32)
    prompt = tokens[:, :PROMPT]
    max_seq = PROMPT + DECODE_STEPS + 4
    cache_j = JM.init_cache(cfg_j, BATCH, max_seq)
    cache_j, last_j = JM.prefill(cfg_j, params_j, {"tokens": jnp.asarray(prompt)}, cache_j)
    cache_t = PM.init_cache(cfg_t, BATCH, max_seq, device="cpu")
    fresh = cache_t
    cache_t, last_t = PM.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(prompt)}, cache_t)
    assert cache_t["scan"] is fresh["scan"]  # written in place
    _close(last_t.float().numpy(), last_j, dtype)

    def check_caches():
        tree_j, tree_t = jax.tree.map(np.asarray, cache_j), to_numpy(cache_t)
        assert jax.tree.structure(tree_j) == jax.tree.structure(tree_t)
        for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert a.shape == b.shape and a.dtype == b.dtype
            _close(a, b, dtype, logits=False)
        if cfg_t.window is not None:  # slot_pos of the ring, and pos, exactly
            np.testing.assert_array_equal(cache_t["scan"][1]["slot_pos"].numpy(),
                                          np.asarray(cache_j["scan"][1]["slot_pos"]))
        np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))

    check_caches()
    steps_j, steps_t = [], []
    for t in range(PROMPT, PROMPT + DECODE_STEPS):
        step = tokens[:, t : t + 1]
        cache_j, lg_j = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(step))
        cache_t, lg_t = PM.decode_step(cfg_t, params_t, cache_t, torch.from_numpy(step))
        steps_j.append(np.asarray(lg_j, np.float32))
        steps_t.append(lg_t.float().numpy())
    # every step's logits; argmax agreement pooled over the 20 steps' rows
    _close(np.stack(steps_t), np.stack(steps_j), dtype)
    check_caches()


def test_block_helpers_match_jax():
    rng = np.random.default_rng(3)
    normal = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    x, conv, state = normal(2, 7, 16), normal(4, 16), normal(2, 3, 16)
    y_j, s_j = JB._causal_conv(jnp.asarray(conv), jnp.asarray(x), jnp.asarray(state))
    y_t, s_t = PB._causal_conv(torch.from_numpy(conv), torch.from_numpy(x),
                               torch.from_numpy(state))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))

    for shift_state in (None, normal(2, 16)):
        for s in (1, 7):
            xs = normal(2, s, 16)
            got = PB._token_shift(torch.from_numpy(xs), None if shift_state is None
                                  else torch.from_numpy(shift_state))
            want = JB._token_shift(jnp.asarray(xs), None if shift_state is None
                                   else jnp.asarray(shift_state))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cfg_j = jax_smoke_config("recurrentgemma-9b").replace(dtype="float32")
    cfg_t = get_smoke_config("recurrentgemma-9b").replace(dtype="float32")
    rp_j = JM.init_params(cfg_j, jax.random.PRNGKey(4))["tail"][0]["rnn"]
    rp_t = to_torch(jax.tree.map(np.asarray, rp_j))
    u = normal(2, 5, cfg_t.d_model)
    a_j, b_j = JB._rglru_gates(cfg_j, rp_j, jnp.asarray(u))
    a_t, b_t = PB._rglru_gates(cfg_t, rp_t, torch.from_numpy(u))
    assert a_t.dtype == b_t.dtype == torch.float32
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5, rtol=1e-5)


SCOPES = ("serve", "serve/admit", "serve/prefill", "serve/decode")
COUNTERS = (
    "serve/queued", "serve/admitted", "serve/shed", "serve/tokens",
    "serve/kv_alloc_blocks", "serve/kv_freed_blocks",
)
# (prompt_len, max_new): request 0 (longer than the window) finishes early,
# so request 2 is admitted mid-stream next to request 1
PLANS = [(40, 3), (20, 8), (12, 5)]


def _scope_counts(db):
    counts = {}
    for root in db.tree():
        for _, node in root.walk():
            counts[node.name] = node.count
    return {s: counts.get(s, 0) for s in SCOPES}


def _serve(engine, make_request, requests):
    handles = [
        engine.submit(make_request(rid, list(prompt), max_new_tokens=max_new))
        for rid, (prompt, max_new) in enumerate(requests)
    ]
    engine.run_until_idle()
    return handles


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_matches_jax_engine(arch):
    cfg_j = jax_smoke_config(arch).replace(dtype="float32")
    cfg_t = get_smoke_config(arch).replace(dtype="float32", seq_impl="pallas", **KERNELS)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(5)
    requests = [([int(t) for t in rng.integers(0, cfg_j.vocab_size, n)], m) for n, m in PLANS]
    max_seq = 56

    before_j = jax_clocks.counter_values(COUNTERS)
    engine_j = JaxServeSession(cfg_j, params_j, n_slots=2, max_seq=max_seq)
    handles_j = _serve(engine_j, JaxRequest, requests)
    delta_j = np.subtract(jax_clocks.counter_values(COUNTERS), before_j)

    before_t = pt_clocks.counter_values(COUNTERS)
    engine_t = ServeSession(cfg_t, params_t, n_slots=2, max_seq=max_seq, device="cpu")
    handles_t = _serve(engine_t, Request, requests)
    delta_t = np.subtract(pt_clocks.counter_values(COUNTERS), before_t)

    assert [h.result().tokens for h in handles_t] == [h.result().tokens for h in handles_j]
    r1, r2 = handles_t[1].result(), handles_t[2].result()
    assert r1.admitted_at < r2.admitted_at < r1.finished_at  # really mid-stream
    assert _scope_counts(pt_timer_db()) == _scope_counts(jax_timer_db())
    assert dict(zip(COUNTERS, delta_t)) == dict(zip(COUNTERS, delta_j))
    stats_t, stats_j = engine_t.stats(), engine_j.stats()
    for key in ("completed", "steps", "tokens", "kv_high_water_blocks", "max_active"):
        assert stats_t[key] == stats_j[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_seq_impl_differentiates_on_cpu(arch):
    """On CPU tensors the recurrence wrappers take their plain versions, which
    autograd differentiates: every leaf gets the gradient of the parallel
    path."""
    base = get_smoke_config(arch).replace(dtype="float32", **KERNELS)
    params = PM.init_params(base, torch.Generator().manual_seed(6), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, base.vocab_size, (2, SEQ), dtype=np.int32))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    grads = {}
    for seq_impl in ("pallas", "parallel"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = PM.loss_fn(base.replace(seq_impl=seq_impl), live, batch)
        grads[seq_impl] = torch.autograd.grad(loss, leaves)
    for g, ref in zip(grads["pallas"], grads["parallel"]):
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0
        torch.testing.assert_close(g, ref, atol=2e-4, rtol=2e-4)
