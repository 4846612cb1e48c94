"""PyTorch port, recurrence kernel modules: the plain versions of the CUDA
RG-LRU and WKV-6 kernels (what their wrappers run on CPU tensors), the
sequential oracles and the parallel forms, against the reference's Pallas
kernels in interpret mode and its jnp forms, on the same inputs.  The CUDA
kernels themselves are held against these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances are the reference's own (``tests/test_kernels_seq.py``):
sequential forms against each other, the Pallas kernels in interpret mode
included, f32 1e-5 (``:95``); the associative scan 1e-4 (``:79``); chunked
WKV-6 f32 2e-4 and bf16 3e-2 (``:48``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import ops as jax_rglru_ops
from repro.kernels.rglru.kernel import rglru_pallas
from repro.kernels.rglru.ref import linear_recurrence_ref as jax_rglru_ref
from repro.kernels.rwkv6 import ops as jax_rwkv_ops
from repro.kernels.rwkv6.kernel import wkv6_pallas
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.bridge import to_torch
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops


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


def _pair(arr, dtype=jnp.float32):
    """The same numbers for both frameworks: a numpy f32 array cast to
    ``dtype`` by JAX, then bridged bit-exactly to torch."""
    j = jnp.asarray(arr).astype(dtype)
    return j, to_torch(np.asarray(j))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# (B, S, D, dtype, with h0): S a multiple of the Pallas chunk (128) and not
RGLRU_CASES = [
    (2, 37, 16, jnp.float32, True),
    (2, 128, 16, jnp.float32, False),
    (1, 256, 32, jnp.float32, True),
    (2, 37, 16, jnp.bfloat16, False),
    (1, 128, 32, jnp.bfloat16, True),
]


def _rglru_inputs(seed, b, s, d, dtype, with_h0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d), dtype=np.float32)))
    a_j, a_t = _pair(a, dtype)
    b_j, b_t = _pair(rng.standard_normal((b, s, d), dtype=np.float32), dtype)
    h0_j, h0_t = _pair(rng.standard_normal((b, d), dtype=np.float32)) if with_h0 else (None, None)
    return (a_j, b_j, h0_j), (a_t, b_t, h0_t)


@pytest.mark.parametrize("b,s,d,dtype,with_h0", RGLRU_CASES)
def test_rglru_plain_matches_pallas_kernel(b, s, d, dtype, with_h0):
    jx, pt = _rglru_inputs(0, b, s, d, dtype, with_h0)
    y_j, f_j = rglru_pallas(*jx, interpret=True)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-5
    for fn in (rg_ops.rglru_fwd_plain, rg_ops.rglru_fwd):  # the wrapper on CPU tensors
        y_t, f_t = fn(*pt)
        assert y_t.dtype == pt[0].dtype and f_t.dtype == torch.float32
        _close(y_t, y_j, tol)
        _close(f_t, f_j, 1e-5)


@pytest.mark.parametrize("b,s,d,dtype,with_h0", RGLRU_CASES)
def test_rglru_ref_and_assoc_match_jax(b, s, d, dtype, with_h0):
    jx, pt = _rglru_inputs(1, b, s, d, dtype, with_h0)
    bf16 = dtype == jnp.bfloat16
    y_j, f_j = jax_rglru_ref(*jx)
    y_t, f_t = rg_ops.linear_recurrence_ref(*pt)
    _close(y_t, y_j, 3e-2 if bf16 else 1e-5)
    _close(f_t, f_j, 1e-5)
    y_j, f_j = jax_rglru_ops.linear_recurrence_assoc(*jx)
    y_t, f_t = rg_ops.linear_recurrence_assoc(*pt)
    assert y_t.dtype == pt[0].dtype and f_t.dtype == torch.float32
    _close(y_t, y_j, 3e-2 if bf16 else 1e-4)
    _close(f_t, f_j, 1e-4)


def test_rglru_dispatch():
    _, (a, b, h0) = _rglru_inputs(2, 1, 16, 4, jnp.float32, True)
    outs = {impl: rg_ops.linear_recurrence(a, b, h0, impl=impl)
            for impl in ("ref", "assoc", "pallas")}
    for impl in ("assoc", "pallas"):
        torch.testing.assert_close(outs[impl][0], outs["ref"][0], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown rglru impl"):
        rg_ops.linear_recurrence(a, b, h0, impl="bogus")


# (B, S, H, K = V, dtype, with state): S a multiple of the chunks (32, 64) and not
WKV_CASES = [
    (1, 37, 2, 16, jnp.float32, True),
    (2, 128, 2, 16, jnp.float32, False),
    (1, 64, 3, 16, jnp.float32, True),
    (1, 37, 2, 16, jnp.bfloat16, False),
    (2, 64, 2, 16, jnp.bfloat16, True),
]


def _wkv_inputs(seed, b, s, h, k, dtype, with_state):
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    r, kk, v = (_pair(normal(b, s, h, k), dtype) for _ in range(3))
    w = _pair(np.exp(-np.exp(normal(b, s, h, k))))  # decays in (0, 1), always f32
    u = _pair(normal(h, k))
    st = _pair(normal(b, h, k, k)) if with_state else (None, None)
    return tuple(zip(r, kk, v, w, u, st))


@pytest.mark.parametrize("b,s,h,k,dtype,with_state", WKV_CASES)
def test_wkv6_plain_matches_pallas_kernel(b, s, h, k, dtype, with_state):
    jx, pt = _wkv_inputs(3, b, s, h, k, dtype, with_state)
    y_j, s_j = wkv6_pallas(*jx, interpret=True)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-5
    for fn in (wk_ops.wkv6_fwd_plain, wk_ops.wkv6_fwd):  # the wrapper on CPU tensors
        y_t, s_t = fn(*pt)
        assert y_t.dtype == pt[0].dtype and s_t.dtype == torch.float32
        _close(y_t, y_j, tol)
        _close(s_t, s_j, 1e-5)


@pytest.mark.parametrize("b,s,h,k,dtype,with_state", WKV_CASES)
def test_wkv6_ref_and_chunked_match_jax(b, s, h, k, dtype, with_state):
    jx, pt = _wkv_inputs(4, b, s, h, k, dtype, with_state)
    bf16 = dtype == jnp.bfloat16
    y_j, s_j = jax_wkv6_ref(*jx)
    y_t, s_t = wk_ops.wkv6_ref(*pt)
    _close(y_t, y_j, 3e-2 if bf16 else 1e-5)
    _close(s_t, s_j, 1e-5)
    y_j, s_j = jax_rwkv_ops.wkv6_chunked(*jx)
    y_t, s_t = wk_ops.wkv6_chunked(*pt)
    assert y_t.dtype == pt[0].dtype and s_t.dtype == torch.float32
    _close(y_t, y_j, 3e-2 if bf16 else 2e-4)
    _close(s_t, s_j, 2e-4)


def test_wkv6_dispatch():
    _, pt = _wkv_inputs(5, 1, 64, 2, 16, jnp.float32, True)
    outs = {impl: wk_ops.wkv6(*pt, impl=impl) for impl in ("ref", "chunked", "pallas")}
    for impl in ("chunked", "pallas"):
        torch.testing.assert_close(outs[impl][0], outs["ref"][0], atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(outs[impl][1], outs["ref"][1], atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        wk_ops.wkv6(*pt, impl="bogus")


# The lengths at which the CUDA kernels' chunking changes (one step; past one
# 32-step WKV-6 chunk) and a decay of about e^-50 a step, at which the WKV-6
# kernel's pairwise exponents would overflow if they were factored: the plain
# versions, which the card checks hold the kernels against, against the
# interpret-mode Pallas kernels.
def _strong_decay(rng, shape):
    return np.exp(-50.0 + rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("decay", ["mixed", "strong"])
def test_rglru_plain_matches_pallas_kernel_at_chunk_edges(s, decay):
    b, d = 2, 16
    (a_j, b_j, h0_j), (a_t, b_t, h0_t) = _rglru_inputs(6, b, s, d, jnp.float32, True)
    if decay == "strong":
        a_j, a_t = _pair(_strong_decay(np.random.default_rng(7), (b, s, d)))
    y_j, f_j = rglru_pallas(a_j, b_j, h0_j, interpret=True)
    y_t, f_t = rg_ops.rglru_fwd_plain(a_t, b_t, h0_t)
    _close(y_t, y_j, 1e-5)
    _close(f_t, f_j, 1e-5)


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("decay", ["mixed", "strong"])
def test_wkv6_plain_matches_pallas_kernel_at_chunk_edges(s, decay):
    b, h, k = 2, 2, 16
    jx, pt = _wkv_inputs(8, b, s, h, k, jnp.float32, True)
    if decay == "strong":
        w_j, w_t = _pair(_strong_decay(np.random.default_rng(9), (b, s, h, k)))
        jx = jx[:3] + (w_j,) + jx[4:]
        pt = pt[:3] + (w_t,) + pt[4:]
    y_j, s_j = wkv6_pallas(*jx, interpret=True)
    y_t, s_t = wk_ops.wkv6_fwd_plain(*pt)
    assert bool(torch.isfinite(y_t).all()) and bool(torch.isfinite(s_t).all())
    _close(y_t, y_j, 1e-5)
    _close(s_t, s_j, 1e-5)
