"""PyTorch port, model: the llama smoke config through the kernel path
(``attn_impl="pallas"``, ``norm_impl="fused"``) at seq 128 — so the reference
runs its interpret-mode flash and RMSNorm kernels — against the reference on
the same bridged weights: ``forward``, ``prefill`` logits and K/V cache, then
four ``decode_step``s.  A ``use_qk_norm`` variant sends the head_dim-wide
norm through the kernel path too.

Tolerances: f32 2e-4; bf16 atol 0.1 / rtol 0.05 with argmax agreement above
0.95 (``tests/test_model_pallas_path.py``).
"""

import dataclasses

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


def _spec_shapes(tree):
    """{path: (shape, dtype name)} of a PSpec tree of either package."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, f"{path}/{key}")
        elif isinstance(node, (tuple, list)):
            for i, value in enumerate(node):
                walk(value, f"{path}/{i}")
        elif node is not None:
            out[path] = (tuple(node.shape), str(np.dtype(node.dtype)) if not isinstance(
                node.dtype, torch.dtype) else str(node.dtype).removeprefix("torch."))

    walk(tree, "")
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_every_reference_arch_resolves_with_the_references_trees(smoke):
    """Every architecture of the reference's registry resolves in the port's
    and builds parameter and cache spec trees (nothing allocated) whose
    paths, shapes and dtypes equal the reference's; the one leaf the port
    adds is each enc-dec decoder layer's source length ``xlen``, int32 on
    the batch axis, so the splicer copies it with the row."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS, get_config

    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    for arch in JAX_ARCH_IDS:
        cfg_j = (jax_smoke_config if smoke else jax_config)(arch)
        cfg_t = (get_smoke_config if smoke else get_config)(arch)
        fields_j = dataclasses.asdict(cfg_j)  # the port adds fields of its own (seq_impl)
        assert {k: v for k, v in dataclasses.asdict(cfg_t).items() if k in fields_j} == fields_j
        assert _spec_shapes(PM.model_specs(cfg_t)) == _spec_shapes(JM.model_specs(cfg_j)), arch
        cache_t = _spec_shapes(PM.cache_specs(cfg_t, 3, 40))
        extra = {path for path in cache_t if path.endswith("/xlen")}
        assert bool(extra) == (cfg_t.family == "encdec"), arch
        for path in extra:
            assert cache_t.pop(path)[1] == "int32"
        if extra:
            assert PM.cache_axes(cfg_t, 3, 40)["scan"][0]["xlen"] == ("layers", "batch")
        assert cache_t == _spec_shapes(JM.cache_specs(cfg_j, 3, 40)), arch
