"""PyTorch port, backward kernel modules: the plain versions of the
hand-written CUDA backward kernels (what the wrappers run on CPU tensors)
against the reference's Pallas kernels in interpret mode, and the port's
``autograd.Function``s against ``jax.grad`` of the reference's wrappers.
The CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: flash gradients f32 5e-4 (``tests/test_kernels_flash.py``), bf16
3e-2; RMSNorm dx 2e-5 / 2e-2 and dw 2e-4 / 3e-2 (f32 / bf16; dw sums over
rows, ``tests/test_kernel_dtype_drift.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JK
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm import kernel as JR
from repro.kernels.rmsnorm.ops import rms_norm_fused as jax_rms_fused
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.bridge import to_torch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops


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


def _inputs(seed, shapes, dtype):
    """Same numbers for both frameworks: numpy f32 normals cast to ``dtype``
    by JAX, then bridged bit-exactly to torch."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(dtype) for s in shapes]
    return arrs, [to_torch(np.asarray(a)) for a in arrs]


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _flash_tol(dtype):
    return 3e-2 if dtype == jnp.bfloat16 else 5e-4


# the tiled cases of tests/test_torch_kernels.py's SWEEP (the reference
# kernels need S and T to be multiples of their 128 blocks)
TILED = [
    # (B, S, T, H, KV, hd, dtype, causal, window)
    (1, 128, 128, 2, 2, 64, jnp.float32, True, None),
    (2, 256, 256, 4, 2, 64, jnp.float32, True, None),     # GQA
    (1, 128, 256, 2, 1, 64, jnp.float32, False, None),    # cross-shape, MQA
    (2, 256, 256, 4, 4, 32, jnp.float32, True, 128),      # sliding window
    (1, 128, 128, 2, 2, 128, jnp.bfloat16, True, None),   # bf16, wide head
    (1, 256, 256, 8, 2, 64, jnp.bfloat16, True, 64),      # bf16 + window + GQA
    (1, 256, 256, 4, 1, 256, jnp.float32, True, 128),     # recurrentgemma: MQA, hd 256
    (1, 256, 256, 4, 1, 256, jnp.bfloat16, True, 128),    # the same in bf16
    (1, 256, 256, 4, 1, 256, jnp.float32, True, None),    # hd 256 causal, no window
]


@pytest.mark.parametrize("b,s,t,h,kv,hd,dtype,causal,window", TILED)
def test_flash_bwd_plain_matches_jax_kernels(b, s, t, h, kv, hd, dtype, causal, window):
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(
        10, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, s, h, hd)], dtype)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731 - reference kernel layout
    blocks = dict(causal=causal, window=window, block_q=128, block_k=128, interpret=True)
    out, lse = JK.flash_fwd(sw(q), sw(k), sw(v), **blocks)
    delta = jnp.sum(sw(do).astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    dq = JK.flash_bwd_dq(sw(q), sw(k), sw(v), sw(do), lse, delta, **blocks)
    dk_h, dv_h = JK.flash_bwd_dkv(sw(q), sw(k), sw(v), sw(do), lse, delta, **blocks)
    # the reference wrapper's GQA reduction (kernels/flash_attention/ops.py:60-63)
    dk = jnp.sum(dk_h.reshape(b, kv, h // kv, t, hd), axis=2).astype(k.dtype)
    dv = jnp.sum(dv_h.reshape(b, kv, h // kv, t, hd), axis=2).astype(v.dtype)

    t_out, t_lse = to_torch(np.asarray(sw(out))), to_torch(np.asarray(lse))
    before = (fa_ops.dq_launches, fa_ops.dkv_launches)
    got = fa_ops.flash_bwd(tq, tk, tv, t_out, t_lse, tdo, causal=causal, window=window)
    assert (fa_ops.dq_launches, fa_ops.dkv_launches) == before  # CPU: the plain version
    assert [g.dtype for g in got] == [tq.dtype, tk.dtype, tv.dtype]
    tol = _flash_tol(dtype)
    for g, ref in zip(got, (sw(dq), sw(dk), sw(dv))):
        _close(g, ref, tol)


@pytest.mark.parametrize("dtype,causal,window,h,kv,hd", [
    pytest.param(jnp.float32, True, None, 4, 2, 64, id="dtype0-True-None"),
    pytest.param(jnp.float32, False, None, 4, 2, 64, id="dtype1-False-None"),
    pytest.param(jnp.float32, True, 128, 4, 2, 64, id="dtype2-True-128"),
    pytest.param(jnp.bfloat16, True, 64, 4, 2, 64, id="dtype3-True-64"),
    # recurrentgemma-9b's attention: MQA, hd 256, a window
    pytest.param(jnp.float32, True, 128, 4, 1, 256, id="hd256-f32-True-128"),
])
def test_flash_autograd_matches_jax_grad(dtype, causal, window, h, kv, hd):
    b, s = 1, 256
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(
        11, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)], dtype)

    def f(q, k, v):
        out = jax_flash(q, k, v, causal=causal, window=window, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    out = fa_ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, tdo)
    tol = _flash_tol(dtype)
    for g, r, x in zip(got, ref, leaves):
        assert g.dtype == x.dtype and g.shape == x.shape
        _close(g, r, tol)


def test_flash_autograd_ragged_matches_jax_chunked_grad():
    """S = T = 100 does not tile: the reference runs ``chunked_attention``
    there, the port its flash path (the kernels mask ragged edges)."""
    b, s, h, kv, hd = 2, 100, 4, 2, 64
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(
        12, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)], jnp.float32)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_chunked(q, k, v, causal=True) * do),
                   argnums=(0, 1, 2))(q, k, v)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, causal=True), leaves, tdo)
    for g, r in zip(got, ref):
        _close(g, r, 5e-4)


def _rms_tols(dtype):
    return (2e-2, 3e-2) if dtype == jnp.bfloat16 else (2e-5, 2e-4)


@pytest.mark.parametrize("n", [256, 100])  # tiled (rows_block 128) and ragged N
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_bwd_plain_matches_jax_kernel(n, d, dtype):
    (x, w, dy), (tx, tw, tdy) = _inputs(13, [(n, d), (d,), (n, d)], dtype)
    dx, dw = JR.rmsnorm_bwd(x, w, dy, eps=1e-5, interpret=True)
    before = rn_ops.bwd_launches
    got_dx, got_dw = rn_ops.rms_norm_bwd(tx, tw, tdy, 1e-5)
    assert rn_ops.bwd_launches == before
    assert got_dx.dtype == tx.dtype and got_dw.dtype == torch.float32
    tol_dx, tol_dw = _rms_tols(dtype)
    _close(got_dx, dx, tol_dx)
    _close(got_dw, dw, tol_dw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_autograd_matches_jax_grad(dtype):
    """Any leading shape; dw comes back in w's dtype (the reference's
    dtype-drift contract, ``tests/test_kernel_dtype_drift.py``)."""
    (x, w, dy), (tx, tw, tdy) = _inputs(14, [(2, 5, 4, 32), (32,), (2, 5, 4, 32)], dtype)

    def f(x, w):
        y = jax_rms_fused(x, w, 1e-5, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * dy.astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1))(x, w)
    leaves = [tx.requires_grad_(), tw.requires_grad_()]
    got = torch.autograd.grad(rn_ops.rms_norm_fused(*leaves, 1e-5), leaves, tdy)
    tol_dx, tol_dw = _rms_tols(dtype)
    for g, r, x_, tol in zip(got, ref, leaves, (tol_dx, tol_dw)):
        assert g.dtype == x_.dtype and g.shape == x_.shape
        _close(g, r, tol)
