"""PyTorch port, model: the llama smoke config through the kernel path
(``attn_impl="pallas"``, ``norm_impl="fused"``) at seq 128 — so the reference
runs its interpret-mode flash and RMSNorm kernels — against the reference on
the same bridged weights: ``forward``, ``prefill`` logits and K/V cache, then
four ``decode_step``s.  A ``use_qk_norm`` variant sends the head_dim-wide
norm through the kernel path too.

Tolerances: f32 2e-4; bf16 atol 0.1 / rtol 0.05 with argmax agreement above
0.95 (``tests/test_model_pallas_path.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as PM

SEQ, BATCH, DECODE_STEPS = 128, 2, 4


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


def _configs(dtype, qk_norm):
    over = dict(attn_impl="pallas", norm_impl="fused", dtype=dtype, use_qk_norm=qk_norm)
    return jax_smoke_config("llama3.2-1b").replace(**over), get_smoke_config("llama3.2-1b").replace(**over)


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
        return
    np.testing.assert_allclose(a, b, atol=0.1, rtol=0.05)
    if a.shape[-1] > 1:
        agree = (a.argmax(-1) == b.argmax(-1)).mean()
        assert agree > 0.95, f"argmax agreement {agree:.3f}"


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_forward_prefill_decode_match_jax(dtype, qk_norm):
    cfg_j, cfg_t = _configs(dtype, qk_norm)
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = to_torch(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (BATCH, SEQ + DECODE_STEPS), dtype=np.int32)
    prompt = tokens[:, :SEQ]

    logits_j, _ = JM.forward(cfg_j, params_j, {"tokens": jnp.asarray(prompt)})
    logits_t = PM.forward(cfg_t, params_t, {"tokens": torch.from_numpy(prompt)})
    _close(_f32(logits_t), logits_j, dtype)

    max_seq = SEQ + DECODE_STEPS + 4
    cache_j = JM.init_cache(cfg_j, BATCH, max_seq)
    cache_j, last_j = JM.prefill(cfg_j, params_j, {"tokens": jnp.asarray(prompt)}, cache_j)
    cache_t = PM.init_cache(cfg_t, BATCH, max_seq, device="cpu")
    cache_t, last_t = PM.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(prompt)}, cache_t)
    _close(_f32(last_t), last_j, dtype)
    for kv in ("k", "v"):
        _close(_f32(cache_t["scan"][0][kv]), cache_j["scan"][0][kv], dtype)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))

    for t in range(SEQ, SEQ + DECODE_STEPS):
        step = tokens[:, t : t + 1]
        cache_j, lg_j = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(step))
        cache_t, lg_t = PM.decode_step(cfg_t, params_t, cache_t, torch.from_numpy(step))
        _close(_f32(lg_t), lg_j, dtype)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))
    _close(_f32(cache_t["scan"][0]["k"]), cache_j["scan"][0]["k"], dtype)


def test_specs_and_cache_layout_match_jax():
    """Same parameter/cache trees (structure, shapes, dtypes) as the reference,
    so bridged weights and caches drop into either package."""
    cfg_j, cfg_t = _configs("bfloat16", True)
    params_j = jax.tree.map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    params_t = PM.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: (a.shape, a.dtype.name), tree)  # noqa: E731
    assert shapes(to_numpy(params_t)) == shapes(params_j)
    cache_j = jax.tree.map(np.asarray, JM.init_cache(cfg_j, 3, 40))
    assert shapes(to_numpy(PM.init_cache(cfg_t, 3, 40, device="cpu"))) == shapes(cache_j)
    assert PM.cache_axes(cfg_t, 3, 40)["scan"][0]["k"] == ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def test_unported_kinds_name_their_roadmap_item():
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1: hybrid family"):
        PM.model_specs(cfg.replace(block_pattern=("rglru", "attn_local")))
    with pytest.raises(KeyError, match="not yet ported"):
        get_smoke_config("rwkv6-1.6b")
