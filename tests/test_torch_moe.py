"""PyTorch port, MoE family: ``models/moe.py`` and the moonshot-v1-16b-a3b /
kimi-k2-1t-a32b smoke configs against the reference on the same bridged
weights.

* ``moe_apply`` in f32 (2e-5) and bf16 (2e-2) on a prefill-shaped input at
  the config's capacity factor and at 0.25 (tokens drop), a decode-shaped
  input (4, 1, d) routed as one group, and (1, 1, d).  Exactly: the chosen
  experts (the reference's ``jax.lax.top_k`` output, intercepted), the
  dropped (token, expert) pairs (against a loop over tokens in order), the
  rows that come out zero; the aux loss at 1e-5.
* The moonshot smoke model on the kernel path: ``prefill`` and three
  ``decode_step``s, f32 at 2e-4, bf16 at the reference's serve tolerance
  (atol 0.15, rtol 0.05, ``tests/test_serve_consistency.py``).
* ``ServeSession`` against the reference engine in f32 at the config's own
  capacity factor, with a mid-stream admission: identical tokens, scope
  counts and ``serve/*`` counter deltas.  A decode step routes all slots as
  one group, free slots included, in both engines.
* Incremental decode against the full ``forward`` at cf = n_experts, where
  nothing drops (``tests/test_serve_consistency.py``'s MoE setting).
* The parameter trees (keys, shapes, dtypes: the router f32) and
  ``param_counts``; ``materialize``'s sliced draw of large leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import clocks as jax_clocks
from repro.core.timers import timer_db as jax_timer_db
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.layers import materialize as jax_materialize
from repro.serving import Request as JaxRequest, ServeSession as JaxServeSession
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import clocks as pt_clocks
from repro_torch.core.timers import timer_db as pt_timer_db
from repro_torch.models import layers
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.models.layers import PSpec, materialize
from repro_torch.serving import Request, ServeSession

ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
KERNELS = dict(attn_impl="pallas", norm_impl="fused")
MOE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (name, input shape, capacity factor; None keeps the config's)
MOE_CASES = [("prefill", (2, 32), None), ("prefill_drops", (2, 32), 0.25),
             ("decode_group", (4, 1), None), ("single", (1, 1), None)]
SEQ, BATCH, DECODE_STEPS = 128, 2, 3
SCOPES = ("serve", "serve/admit", "serve/prefill", "serve/decode")
COUNTERS = ("serve/queued", "serve/admitted", "serve/shed", "serve/tokens",
            "serve/kv_alloc_blocks", "serve/kv_freed_blocks")
# (prompt_len, max_new): request 0 finishes early, so request 2 is admitted
# mid-stream next to request 1, at a different position
PLANS = [(128, 3), (20, 8), (12, 5)]


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


def _with_cf(cfg, cf):
    return cfg if cf is None else cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _dropped_by_loop(top_i, cap, n_experts):
    """(G, S, E) bool: the (token, expert) choices past the expert's capacity,
    counting each group's tokens in order."""
    g, s, _ = top_i.shape
    dropped = np.zeros((g, s, n_experts), bool)
    for gi in range(g):
        taken = np.zeros(n_experts, int)
        for t in range(s):
            for e in top_i[gi, t]:
                dropped[gi, t, e] = taken[e] >= cap
                taken[e] += 1
    return dropped


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,shape,cf", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_jax(monkeypatch, arch, dtype, case, shape, cf):
    cfg_j = _with_cf(jax_smoke_config(arch).replace(dtype=dtype), cf)
    cfg_t = _with_cf(get_smoke_config(arch).replace(dtype=dtype), cf)
    p_j = jax_materialize(JMoE.moe_specs(cfg_j), jax.random.PRNGKey(0))
    p_t = to_torch(jax.tree.map(np.asarray, p_j))
    x = np.random.default_rng(1).standard_normal(shape + (cfg_j.d_model,)).astype(np.float32)
    x_j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    x_t = to_torch(np.asarray(x_j))

    top_k = jax.lax.top_k
    chosen = []

    def spy(a, k):
        out = top_k(a, k)
        chosen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    y_j, aux_j = JMoE.moe_apply(cfg_j, p_j, x_j)
    monkeypatch.undo()
    y_t, aux_t = PMoE.moe_apply(cfg_t, p_t, x_t)

    b, s, d = shape + (cfg_j.d_model,)
    groups = x_t.reshape(1, b, d) if s == 1 and b > 1 else x_t
    routing = PMoE.route(cfg_t, p_t["router"], groups)
    (top_i_j,) = chosen
    np.testing.assert_array_equal(routing.top_i.numpy(), top_i_j)
    cap = routing.token_idx.shape[-1]
    dropped = _dropped_by_loop(top_i_j, cap, cfg_j.moe.n_experts)
    np.testing.assert_array_equal((routing.mask.numpy() == 1) & ~routing.keep.numpy(), dropped)
    if case == "prefill_drops":
        assert dropped.any()

    y_j, y_t = np.asarray(y_j, np.float32), y_t.float().numpy()
    np.testing.assert_array_equal((y_t == 0).all(-1), (y_j == 0).all(-1))
    if case == "prefill_drops":  # some tokens lost every choice: they pass through
        assert (y_j == 0).all(-1).any() and not (y_j == 0).all()
    np.testing.assert_allclose(y_t, y_j, atol=MOE_TOL[dtype], rtol=MOE_TOL[dtype])
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-5, rtol=1e-5)


def _model_configs(arch, dtype, cf=None):
    over = dict(KERNELS, dtype=dtype)
    return (_with_cf(jax_smoke_config(arch).replace(**over), cf),
            _with_cf(get_smoke_config(arch).replace(**over), cf))


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
    else:
        np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moonshot_prefill_decode_match_jax(dtype):
    """The smoke model on the kernel path (the reference's interpret-mode flash
    and RMSNorm kernels at seq 128): prefill logits and K/V cache, then three
    decode steps, each routing the batch of 2 as one group."""
    cfg_j, cfg_t = _model_configs("moonshot-v1-16b-a3b", dtype)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ + DECODE_STEPS), dtype=np.int32)
    prompt = tokens[:, :SEQ]
    max_seq = SEQ + DECODE_STEPS + 4
    cache_j = JM.init_cache(cfg_j, BATCH, max_seq)
    cache_j, last_j = JM.prefill(cfg_j, params_j, {"tokens": jnp.asarray(prompt)}, cache_j)
    cache_t = PM.init_cache(cfg_t, BATCH, max_seq, device="cpu")
    cache_t, last_t = PM.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(prompt)}, cache_t)
    _close(last_t.float(), last_j, dtype)
    for kv in ("k", "v"):
        _close(cache_t["scan"][0][kv].float(), cache_j["scan"][0][kv], dtype)
    for t in range(SEQ, SEQ + DECODE_STEPS):
        step = tokens[:, t : t + 1]
        cache_j, lg_j = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(step))
        cache_t, lg_t = PM.decode_step(cfg_t, params_t, cache_t, torch.from_numpy(step))
        _close(lg_t.float(), lg_j, dtype)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))


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
    """f32 at the config's own capacity factor (1.25): a decode step of two
    slots has capacity 1 an expert, so a slot, or the free slot, can take an
    expert from the other; both engines must route alike to agree."""
    cfg_j, cfg_t = _model_configs("moonshot-v1-16b-a3b", "float32")
    assert cfg_t.moe.capacity_factor == 1.25
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(3)
    requests = [([int(t) for t in rng.integers(0, cfg_j.vocab_size, plen)], max_new)
                for plen, max_new in PLANS]
    max_seq = 144

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


def test_incremental_decode_matches_full_forward():
    """The port against itself: prefill of 32 tokens then 5 decode steps give
    the full forward's logits at those positions, at cf = n_experts, where
    no routing group drops a token (tests/test_serve_consistency.py)."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(**KERNELS)
    cfg = _with_cf(cfg, float(cfg.moe.n_experts))
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s_prompt, s_decode = 2, 32, 6
    total = s_prompt + s_decode
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (b, total), dtype=np.int32))
    full = PM.forward(cfg, params, {"tokens": tokens})[:, s_prompt - 1 : total - 1]
    cache = PM.init_cache(cfg, b, total + 2, device="cpu")
    cache, logits = PM.prefill(cfg, params, {"tokens": tokens[:, :s_prompt]}, cache)
    inc = [logits]
    for t in range(s_prompt, total - 1):
        cache, logits = PM.decode_step(cfg, params, cache, tokens[:, t : t + 1])
        inc.append(logits)
    inc = torch.stack(inc, dim=1).float().numpy()
    full = full.float().numpy()
    np.testing.assert_allclose(inc, full, atol=0.15, rtol=0.05)
    agree = (inc.argmax(-1) == full.argmax(-1)).mean()
    assert agree > 0.95, f"argmax agreement {agree:.3f}"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_and_counts_match_jax(arch):
    """Same parameter tree (keys, shapes, dtypes; the router f32 in a bf16
    model) in both packages, bridged weights keep it, and the same
    (total, active) counts at smoke and published widths."""
    cfg_j, cfg_t = jax_smoke_config(arch), get_smoke_config(arch)
    params_j = jax.tree.map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    params_t = PM.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: (a.shape, a.dtype.name), tree)  # noqa: E731
    assert shapes(to_numpy(params_t)) == shapes(params_j)
    assert shapes(to_numpy(to_torch(params_j))) == shapes(params_j)
    moe = params_t["scan"][0]["moe"]
    assert sorted(moe) == ["router", "wg", "wi", "wo"] and "mlp" not in params_t["scan"][0]
    assert moe["router"].dtype == torch.float32 and moe["wi"].dtype == torch.bfloat16
    for full in (False, True):
        cj = jax_config(arch) if full else cfg_j
        ct = get_config(arch) if full else cfg_t
        assert PM.param_counts(ct) == JM.param_counts(cj)
    if arch == "moonshot-v1-16b-a3b":  # 28.06 B parameters, 56.1 GB in bf16
        assert PM.param_counts(get_config(arch))[0] == 28_057_995_264


def test_materialize_draws_large_leaves_by_slice(monkeypatch):
    """A leaf above ``MAX_DRAW_ELEMENTS`` is drawn one leading slice at a
    time: the leaf's shape, dtype and scale, the same values for the same
    seed, and every slice a fresh draw; a leaf at or below it keeps the
    one-draw values (``torch.randn`` of the whole shape, scaled, cast)."""
    spec = PSpec((3, 4, 64, 32), ("layers", "expert", "embed", "expert_ffn"))
    scale = 64 ** -0.5

    def draw(max_draw):
        monkeypatch.setattr(layers, "MAX_DRAW_ELEMENTS", max_draw)
        return materialize({"w": spec}, torch.Generator().manual_seed(5), "cpu")["w"]

    sliced = draw(4 * 64 * 32 - 1)  # each (64, 32) matrix its own draw
    assert sliced.shape == spec.shape and sliced.dtype == torch.bfloat16
    assert torch.equal(sliced, draw(4 * 64 * 32 - 1))
    std = sliced.float().std().item()
    assert abs(std / scale - 1) < 0.03, std
    first = torch.randn((64, 32), generator=torch.Generator().manual_seed(5)) * scale
    assert torch.equal(sliced[0, 0], first.to(torch.bfloat16))
    assert not torch.equal(sliced[0, 0], sliced[0, 1])
    whole = torch.randn(spec.shape, generator=torch.Generator().manual_seed(5)) * scale
    assert torch.equal(draw(spec.shape[0] * 4 * 64 * 32), whole.to(torch.bfloat16))
