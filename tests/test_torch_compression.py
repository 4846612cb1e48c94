"""PyTorch port, ``optim/compression.py``: the error-feedback int8 quantizer
against the reference's (the int8 payload exactly, the scale to 1e-7
relative, the residual too), the reference's error-feedback bias and
round-trip tests (``tests/test_data_optim.py``), and
``cross_pod_mean_compressed`` over 2 and 4 gloo processes against the
reference's per-pod ``ef_quantize`` followed by the mean of the dequantized
payloads: on a ``("pod",)`` mesh of every rank, and over the ``"data"``
axis of a (2, 2) ``("data", "model")`` mesh, whose two data groups reduce
apart.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import run_ranks
from repro_torch.optim import compression as C

SHAPES = {"w": (64, 48), "b": (48,), "scalar": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


@pytest.fixture(scope="module")
def JC():
    """The reference's module, imported here so that the spawned ranks, which
    import this file, do not load JAX."""
    from repro.optim import compression

    return compression


def _jax(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_ef_quantize_matches_reference(JC, seed, scale):
    g, ef = _tree(seed, scale), _tree(seed + 100, scale * 0.01)
    jq, js, jef = JC.ef_quantize(_jax(g), _jax(ef))
    q, s, new_ef = C.ef_quantize(_torch(g), _torch(ef))
    for k in SHAPES:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), rtol=1e-7)
        np.testing.assert_allclose(new_ef[k].numpy(), np.asarray(jef[k]), rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(C.dequantize(q, s)[k].numpy(),
                                   np.asarray(JC.dequantize(jq, js)[k]), rtol=1e-7)
    zero = C.ef_init(_torch(g))
    assert all(zero[k].dtype == torch.float32 and not zero[k].any() for k in SHAPES)


def test_ef_quantize_error_feedback_reduces_bias():
    """With error feedback, the *accumulated* quantized signal tracks the true
    accumulated signal (bias does not grow)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(256).astype(np.float32))}
    ef = C.ef_init(g)
    acc_q = np.zeros(256)
    for _ in range(20):
        q, s, ef = C.ef_quantize(g, ef)
        acc_q += C.dequantize(q, s)["w"].numpy()
    acc_true = 20 * g["w"].numpy()
    rel = np.abs(acc_q - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.01


def test_quantize_roundtrip_range():
    x = {"w": torch.tensor([-3.0, 0.0, 1.5])}
    q, s, _ = C.ef_quantize(x, C.ef_init(x))
    assert q["w"].dtype == torch.int8
    back = C.dequantize(q, s)["w"]
    np.testing.assert_allclose(back.numpy(), x["w"].numpy(), atol=3.0 / 127 + 1e-6)


def test_cross_pod_mean_needs_a_sharding_context():
    with pytest.raises(RuntimeError, match="use_sharding"):
        C.cross_pod_mean_compressed(_torch(_tree(0)), C.ef_init(_torch(_tree(0))))


def _worker(rank, world, mesh_shape, axis):
    from repro_torch.dist.context import use_sharding
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.sharding import DEFAULT_RULES

    torch.set_num_threads(1)
    names = ("pod",) if len(mesh_shape) == 1 else ("data", "model")
    mesh = device_mesh(mesh_shape, names, device="cpu")
    g, ef = _torch(_tree(rank)), _torch(_tree(rank + 100, 0.01))
    with use_sharding(mesh, DEFAULT_RULES):
        mean, new_ef = C.cross_pod_mean_compressed(g, ef, axis_name=axis)
    return ({k: v.numpy() for k, v in mean.items()}, {k: v.numpy() for k, v in new_ef.items()},
            [int(r) for r in torch.distributed.get_process_group_ranks(mesh.get_group(axis))])


@pytest.fixture(scope="module", params=[((2,), "pod"), ((4,), "pod"), ((2, 2), "data")],
                ids=["pod2", "pod4", "data2_of_2x2"])
def reduced(request):
    mesh_shape, axis = request.param
    world = int(np.prod(mesh_shape))
    return run_ranks(_worker, world, mesh_shape, axis)


def test_cross_pod_mean_compressed_matches_reference(JC, reduced):
    for rank, (mean, new_ef, group) in enumerate(reduced):
        assert rank in group and len(group) in (2, 4)
        deq, want_ef = [], None
        for member in group:  # the reference's per-pod quantize, then the mean
            q, s, ef = JC.ef_quantize(_jax(_tree(member)), _jax(_tree(member + 100, 0.01)))
            deq.append({k: np.asarray(v) for k, v in JC.dequantize(q, s).items()})
            if member == rank:
                want_ef = ef
        for k in SHAPES:
            want = np.sum([d[k] for d in deq], axis=0) / len(group)
            np.testing.assert_allclose(mean[k], want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(new_ef[k], np.asarray(want_ef[k]), rtol=1e-7, atol=1e-7)
