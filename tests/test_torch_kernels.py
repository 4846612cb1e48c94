"""PyTorch port, kernel modules: the plain versions of the hand-written CUDA
kernels (what the wrappers run on CPU tensors) against the reference's Pallas
kernels in interpret mode, plus the port's attention implementations against
the reference's.  The CUDA kernels themselves are held against these plain
versions on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: f32 2e-5, bf16 2e-2 (the reference's own kernel tolerances,
``tests/test_kernels_flash.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jax_flash_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm.ops import rms_norm_fused as jax_rms_fused
from repro.models import attention as jax_attention
from repro_torch.bridge import to_torch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import attention as pt_attention


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


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == jnp.bfloat16 else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, shapes, dtype):
    """Same numbers for both frameworks: numpy f32 normals cast to ``dtype``
    by JAX, then bridged bit-exactly to torch."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(dtype) for s in shapes]
    return arrs, [to_torch(np.asarray(a)) for a in arrs]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


SWEEP = [
    # (B, S, T, H, KV, hd, dtype, causal, window) — tests/test_kernels_flash.py
    (1, 128, 128, 2, 2, 64, jnp.float32, True, None),
    (2, 256, 256, 4, 2, 64, jnp.float32, True, None),     # GQA
    (1, 128, 256, 2, 1, 64, jnp.float32, False, None),    # cross-shape, MQA
    (2, 256, 256, 4, 4, 32, jnp.float32, True, 128),      # sliding window
    (1, 128, 128, 2, 2, 128, jnp.bfloat16, True, None),   # bf16, wide head
    (1, 256, 256, 8, 2, 64, jnp.bfloat16, True, 64),      # bf16 + window + GQA
    (1, 100, 100, 4, 2, 64, jnp.float32, True, None),     # ragged S = T
]


@pytest.mark.parametrize("b,s,t,h,kv,hd,dtype,causal,window", SWEEP)
def test_flash_plain_matches_jax_kernel(b, s, t, h, kv, hd, dtype, causal, window):
    (q, k, v), (tq, tk, tv) = _inputs(0, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)], dtype)
    ref = jax_flash(q, k, v, causal=causal, window=window, interpret=True)
    before = fa_ops.launches
    out = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa_ops.launches == before  # CPU tensors take the plain version
    assert out.dtype == tq.dtype and out.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 128)])
def test_flash_plain_lse_matches_jax_kernel(causal, window):
    """The kernel's second output: lse (B, H, S) in f32."""
    b, s, h, kv, hd = 1, 256, 4, 2, 64
    (q, k, v), (tq, tk, tv) = _inputs(1, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], jnp.float32)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731 - reference kernel layout
    out_j, lse_j = jax_flash_kernel.flash_fwd(
        sw(q), sw(k), sw(v), causal=causal, window=window, block_q=128, block_k=128,
        interpret=True,
    )
    out, lse = fa_ops.flash_fwd_plain(tq, tk, tv, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(_np(lse), _np(lse_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out), _np(sw(out_j)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", [256, 100])  # tiled (rows_block 128) and ragged N
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_plain_matches_jax_kernel(n, d, dtype):
    (x, w), (tx, tw) = _inputs(2, [(n, d), (d,)], dtype)
    ref = jax_rms_fused(x, w, 1e-5, interpret=True)
    before = rn_ops.launches
    out = rn_ops.rms_norm_fused(tx, tw, 1e-5)
    assert rn_ops.launches == before
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


def test_rmsnorm_any_leading_shape():
    (x, w), (tx, tw) = _inputs(3, [(2, 5, 4, 32), (32,)], jnp.float32)
    out = rn_ops.rms_norm_fused(tx, tw)
    assert out.shape == (2, 5, 4, 32)
    np.testing.assert_allclose(_np(out), _np(jax_rms_fused(x, w, interpret=True)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("window", [None, 48])
def test_attention_impls_match_jax(impl, dtype, window):
    b, s, h, kv, hd = 2, 128, 4, 2, 16
    (q, k, v), (tq, tk, tv) = _inputs(4, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype)
    ref = jax_attention.attention(q, k, v, impl=impl, window=window, chunk=32)
    out = pt_attention.attention(tq, tk, tv, impl=impl, window=window, chunk=32)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches_jax(dtype):
    b, t, h, kv, hd = 3, 40, 4, 2, 16
    (q, kc, vc), (tq, tkc, tvc) = _inputs(5, [(b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)], dtype)
    pos = np.array([5, 17, 39])
    valid = np.arange(t)[None, :] <= pos[:, None]
    ref = jax_attention.decode_attention(q, kc, vc, jnp.asarray(valid))
    out = pt_attention.decode_attention(tq, tkc, tvc, torch.from_numpy(valid))
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))
