"""PyTorch port, serving: the port's ``ServeSession`` against the reference's.

* f32, kernel path (``attn_impl="pallas"``, ``norm_impl="fused"``): on the
  same bridged weights and requests — one 128-token prompt, so the reference
  runs its interpret-mode flash kernel, and a mid-stream admission — the two
  engines emit identical tokens, open the same number of ``serve`` scope
  windows and bump the ``serve/*`` counters by the same amounts.
* bf16: continuous batching equals serving each request alone
  (``tests/test_serve_consistency.py``'s invariant, in the port).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import clocks as jax_clocks
from repro.core.timers import timer_db as jax_timer_db
from repro.models import model as JM
from repro.serving import Request as JaxRequest, ServeSession as JaxServeSession
from repro_torch.bridge import to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import clocks as pt_clocks
from repro_torch.core.timers import timer_db as pt_timer_db
from repro_torch.launch.serve import run_serving
from repro_torch.models import model as PM
from repro_torch.serving import Request, ServeSession

SCOPES = ("serve", "serve/admit", "serve/prefill", "serve/decode")
COUNTERS = (
    "serve/queued", "serve/admitted", "serve/shed", "serve/tokens",
    "serve/kv_alloc_blocks", "serve/kv_freed_blocks",
)
# (prompt_len, max_new): request 0 finishes early, so request 2 is admitted
# mid-stream next to request 1, at a different position
PLANS = [(128, 3), (20, 8), (12, 5)]


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


def _requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, vocab, plen)], max_new) for plen, max_new in PLANS]


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


def test_serve_session_matches_jax_engine():
    over = dict(dtype="float32", attn_impl="pallas", norm_impl="fused")
    cfg_j = jax_smoke_config("llama3.2-1b").replace(**over)
    cfg_t = get_smoke_config("llama3.2-1b").replace(**over)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    requests = _requests(cfg_j.vocab_size)
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


def _alone(cfg, params, prompt, max_new, max_seq):
    """Greedy tokens for one request served alone: batch-1 prefill then
    single-row decode — the unbatched ground truth."""
    cache = PM.init_cache(cfg, 1, max_seq, device="cpu")
    cache, logits = PM.prefill(cfg, params, {"tokens": torch.tensor([prompt])}, cache)
    toks = [int(torch.argmax(logits[0, : cfg.vocab_size]))]
    for _ in range(max_new - 1):
        cache, logits = PM.decode_step(cfg, params, cache, torch.tensor([[toks[-1]]]))
        toks.append(int(torch.argmax(logits[0, : cfg.vocab_size])))
    return toks


def test_continuous_batching_matches_unbatched_bf16():
    cfg = get_smoke_config("llama3.2-1b").replace(attn_impl="pallas", norm_impl="fused")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    requests = _requests(cfg.vocab_size, seed=4)
    max_seq = 144
    reference = [_alone(cfg, params, p, n, max_seq) for p, n in requests]
    engine = ServeSession(cfg, params, n_slots=2, max_seq=max_seq, control=False, device="cpu")
    handles = _serve(engine, Request, requests)
    assert [h.result().tokens for h in handles] == reference


def test_run_serving_cpu_smoke():
    """The launcher's entry point end to end on the CPU, with mixed prompt
    lengths and the kernel implementations selected."""
    engine = run_serving(
        n_requests=5, prompt_len=[24, 9], max_new=4, n_slots=2,
        attn_impl="pallas", norm_impl="fused", device="cpu",
    )
    stats = engine.stats()
    assert stats["completed"] == 5.0 and stats["tokens"] == 20.0
    assert sorted(r.prompt_len for r in engine.completed) == [9, 9, 24, 24, 24]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
def test_free_slot_past_max_seq_matches_jax_engine(arch):
    """A free slot decodes on, its position past the cache's end: the
    reference drops those cache writes (a JAX scatter drops out-of-range
    updates) and the port must too, not raise.  Request 0 (slot 0) finishes
    after 2 tokens and its row then runs 28 steps past ``max_seq`` while
    request 1 decodes in slot 1; under MoE the free row routes first in the
    decode group (capacity 1 an expert at 2 slots), so its evolution decides
    slot 1's drops.  f32, the kernel settings: identical tokens."""
    over = dict(dtype="float32", attn_impl="pallas", norm_impl="fused")
    cfg_j = jax_smoke_config(arch).replace(**over)
    cfg_t = get_smoke_config(arch).replace(**over)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(5)
    requests = [([int(t) for t in rng.integers(0, cfg_j.vocab_size, plen)], max_new)
                for plen, max_new in ((30, 2), (4, 30))]
    max_seq = 40
    handles_j = _serve(JaxServeSession(cfg_j, params_j, n_slots=2, max_seq=max_seq,
                                       control=False), JaxRequest, requests)
    engine_t = ServeSession(cfg_t, params_t, n_slots=2, max_seq=max_seq, control=False,
                            device="cpu")
    handles_t = _serve(engine_t, Request, requests)
    assert int(engine_t._cache["pos"][0]) > max_seq  # the free row ran past the end
    assert [h.result().tokens for h in handles_t] == [h.result().tokens for h in handles_j]
