"""PyTorch port, attention masks with a query offset: the port's
``naive_attention``, ``chunked_attention`` and ``attention`` against the
reference's at ``q_offset > 0`` (the position of the first query in the causal
and window masks), causal and windowed, with S != T, a chunk that divides S
(the chunk loop, and its K/V band under a window) and one that does not (the
naive fallback).  The ``"pallas"`` branch drops ``q_offset`` in both packages.
Also ``TrainSettings.eval_every``, which both packages take and no code reads.

Tolerance: f32 2e-5 (``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import TrainSettings as JaxTrainSettings
from repro.models import attention as jax_attention
from repro_torch.bridge import to_torch
from repro_torch.launch.train import TrainSettings
from repro_torch.models import attention as pt_attention

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]
    return [jnp.asarray(a) for a in arrs], [to_torch(a) for a in arrs]


CASES = [
    # (S, T, q_offset, causal, window, chunk): a decode-like suffix of T, or
    # a window; chunk 16 divides S (the loop), 24 does not (naive fallback)
    (48, 80, 32, True, None, 16),
    (48, 80, 32, True, None, 24),
    (48, 80, 32, True, 20, 16),
    (48, 80, 32, True, 20, 24),
    (40, 64, 8, False, 12, 24),
    (32, 40, 5, False, None, 16),
    # T past the K/V band (window + chunk rounded up to 128): the band slides
    (192, 256, 16, True, 32, 64),
]


@pytest.mark.parametrize("fn", ["naive", "chunked", "attention_naive", "attention_chunked"])
@pytest.mark.parametrize("s,t,q_offset,causal,window,chunk", CASES)
def test_q_offset_matches_jax(fn, s, t, q_offset, causal, window, chunk):
    (q, k, v), (tq, tk, tv) = _inputs(s + t + q_offset, 2, s, t, 4, 2, 16)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    if fn == "naive":
        ref = jax_attention.naive_attention(q, k, v, **mask)
        out = pt_attention.naive_attention(tq, tk, tv, **mask)
    elif fn == "chunked":
        ref = jax_attention.chunked_attention(q, k, v, chunk=chunk, **mask)
        out = pt_attention.chunked_attention(tq, tk, tv, chunk=chunk, **mask)
    else:
        impl = fn.split("_")[1]
        ref = jax_attention.attention(q, k, v, impl=impl, chunk=chunk, **mask)
        out = pt_attention.attention(tq, tk, tv, impl=impl, chunk=chunk, **mask)
    assert out.shape == (2, s, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the offset moves the masks: the result differs from the one at 0
    if causal or window is not None:
        at0 = pt_attention.naive_attention(tq, tk, tv, causal=causal, window=window)
        assert not np.allclose(out.numpy(), at0.numpy(), **TOL)


def test_pallas_branch_drops_q_offset():
    """As the reference's, the flash branch takes no offset: its masks start
    at 0 (S = T = 100 does not tile, so the reference runs its chunked
    fallback without the offset; the port on CPU tensors the plain flash)."""
    (q, k, v), (tq, tk, tv) = _inputs(7, 1, 100, 100, 4, 2, 16)
    ref = jax_attention.attention(q, k, v, impl="pallas", q_offset=9)
    out = pt_attention.attention(tq, tk, tv, impl="pallas", q_offset=9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out.numpy(), pt_attention.attention(tq, tk, tv, impl="pallas").numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("settings", [JaxTrainSettings, TrainSettings])
def test_train_settings_take_eval_every(settings):
    assert settings(eval_every=5).eval_every == 5
    assert settings().eval_every == 0

