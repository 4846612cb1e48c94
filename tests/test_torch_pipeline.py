"""PyTorch port, pipeline schedules (``repro_torch.dist.pipeline``) and meshes
(``repro_torch.dist.meshutil``) against the reference.

``StagePlan.pack``/``unpack`` and ``phase_ticks`` are held against the JAX
functions; ``gpipe_forward`` and the MLP ``PipelineStep`` against the JAX ones
on a 1-device ``pod`` mesh (with no stage mask: the reference's masked 1F1B
raises ``ShardingTypeError`` under this container's jax); and the port on 2
and 4 CPU ranks — where the reference's own criterion holds it — against
``jax.value_and_grad`` of the non-pipelined scan
(``tests/test_pipeline_1f1b.py:_reference``), at 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.meshutil import local_mesh as jax_local_mesh
from repro.dist.pipeline import PipelineStep as JaxPipelineStep
from repro.dist.pipeline import StagePlan as JaxStagePlan
from repro.dist.pipeline import gpipe_forward as jax_gpipe_forward
from repro.dist.pipeline import phase_ticks as jax_phase_ticks
from repro_torch.dist import meshutil
from repro_torch.dist.meshutil import Mesh, local_mesh, pipeline_submeshes, remove_host
from repro_torch.dist.sharding import PartitionSpec
from repro_torch.dist.pipeline import (
    PipelineStep,
    StagePlan,
    gpipe_forward,
    phase_ticks,
    pipeline_step,
)

WIDTH = 8
MICRO_BATCH = 2
TOL = 1e-5


def _layer_fn_j(w, a):
    return a + jnp.tanh(a @ w[0]) @ w[1] * 0.1


def _layer_fn(w, a):
    return a + torch.tanh(a @ w[0]) @ w[1] * 0.1


def _loss_fn_j(y, t):
    return jnp.mean((y - t) ** 2)


def _loss_fn(y, t):
    return ((y - t) ** 2).mean()


def _inputs(n_micro, n_layers, seed):
    """(layers, x, targets) as f32 numpy normals."""
    rng = np.random.default_rng(seed)
    batch = n_micro * MICRO_BATCH
    layers = rng.standard_normal((n_layers, 2, WIDTH, WIDTH), dtype=np.float32) * 0.3
    return (layers, rng.standard_normal((batch, WIDTH), dtype=np.float32),
            rng.standard_normal((batch, WIDTH), dtype=np.float32))


def _reference(layers, x, tgt, n_micro, loss_fn=_loss_fn_j):
    """Single-device, non-pipelined: scan all layers, mean loss over
    microbatches — the ground truth the schedule must reproduce."""

    def loss(ls):
        def seq(a):
            out, _ = jax.lax.scan(lambda acc, w: (_layer_fn_j(w, acc), None), a, ls)
            return out

        micro = jnp.asarray(x).reshape((n_micro, -1) + x.shape[1:])
        tmicro = jnp.asarray(tgt).reshape((n_micro, -1) + tgt.shape[1:])
        return jnp.mean(jax.vmap(lambda a, t: loss_fn(seq(a), t))(micro, tmicro))

    loss, grads = jax.value_and_grad(loss)(jnp.asarray(layers))
    return float(loss), np.asarray(grads)


def _cpu_mesh(n):
    return local_mesh((n,), ("pod",), device="cpu")


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# StagePlan packing and the tick ranges against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers,weights", [
    (4, {0: 1.0, 1: 1.0}),
    (5, {0: 2.0, 1: 1.0}),
    (6, {0: 2.0, 1: 1.0, 2: 1.0, 3: 1.0}),
    (11, {0: 0.34, 1: 2.14, 2: 2.73}),
    (16, {0: 1.0, 1: 0.5, 2: 1.0, 3: 1.0}),
])
def test_pack_unpack_and_mask_match_jax(n_layers, weights):
    rng = np.random.default_rng(n_layers)
    tree = {"w": rng.standard_normal((n_layers, 3, 2), dtype=np.float32),
            "b": (rng.standard_normal((n_layers, 5), dtype=np.float32),)}
    plan_j = JaxStagePlan(n_layers=n_layers, weights=dict(weights))
    plan_t = StagePlan(n_layers=n_layers, weights=dict(weights))
    packed_j, mask_j = plan_j.pack(jax.tree.map(jnp.asarray, tree))
    packed_t, mask_t = plan_t.pack({"w": torch.from_numpy(tree["w"]),
                                    "b": (torch.from_numpy(tree["b"][0]),)})
    assert mask_t.dtype == torch.bool and mask_t.device.type == "cpu"
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(packed_t["w"].numpy(), np.asarray(packed_j["w"]))
    np.testing.assert_array_equal(packed_t["b"][0].numpy(), np.asarray(packed_j["b"][0]))
    back = plan_t.unpack(packed_t)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(back["b"][0].numpy(), tree["b"][0])
    assert plan_t._slot_rows() == plan_j._slot_rows()


@pytest.mark.parametrize("axis_size", [1, 2, 3, 4, 5])
def test_phase_ticks_match_jax_and_partition_the_schedule(axis_size):
    for n_micro in range(1, 2 * axis_size + 4):
        ranges = phase_ticks(n_micro, axis_size)
        assert ranges == jax_phase_ticks(n_micro, axis_size)
        assert ranges["warmup"][0] == 0
        assert ranges["warmup"][1] == ranges["steady"][0]
        assert ranges["steady"][1] == ranges["cooldown"][0]
        assert ranges["cooldown"][1] == n_micro + 2 * axis_size - 1
        for t0, t1 in ranges.values():
            assert 0 <= t0 <= t1


# ---------------------------------------------------------------------------
# gpipe_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (3, 3), (4, 2)])
def test_gpipe_forward_matches_jax_on_one_device(n_stages, n_micro):
    rng = np.random.default_rng(n_stages)
    w = rng.standard_normal((n_stages, WIDTH), dtype=np.float32)
    x = rng.standard_normal((n_micro * MICRO_BATCH, WIDTH), dtype=np.float32)
    ref = jax_gpipe_forward(lambda a, b: jnp.tanh(b * a), jnp.asarray(w), jnp.asarray(x),
                            mesh=jax_local_mesh((1,), ("pod",)), axis="pod", n_micro=n_micro)
    got = gpipe_forward(lambda a, b: torch.tanh(b * a), torch.from_numpy(w),
                        torch.from_numpy(x), mesh=_cpu_mesh(1), axis="pod", n_micro=n_micro)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gpipe_forward_matches_sequential_on_cpu_ranks(n_ranks):
    rng = np.random.default_rng(n_ranks)
    w = torch.from_numpy(rng.standard_normal((2 * n_ranks, WIDTH), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((5 * MICRO_BATCH, WIDTH), dtype=np.float32))
    want = x
    for row in w:
        want = torch.tanh(row * want)
    got = gpipe_forward(lambda a, b: torch.tanh(b * a), w, x, mesh=_cpu_mesh(n_ranks),
                        axis="pod", n_micro=5)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The 1F1B step against the JAX PipelineStep (1-device pod mesh, no mask)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots,n_micro", [
    (1, 3), (2, 3), (4, 3), (2, 1), (2, 2), (2, 5), (2, 8),
])
def test_1f1b_matches_jax_pipeline_step(n_slots, n_micro):
    layers, x, tgt = _inputs(n_micro, n_slots, seed=10 * n_slots + n_micro)
    step_j = JaxPipelineStep(_layer_fn_j, _loss_fn_j, mesh=jax_local_mesh((1,), ("pod",)),
                             axis="pod", n_micro=n_micro)
    loss_j, grads_j = step_j(jnp.asarray(layers), jnp.asarray(x), jnp.asarray(tgt))
    loss, grads = pipeline_step(_layer_fn, torch.from_numpy(layers), torch.from_numpy(x),
                                torch.from_numpy(tgt), loss_fn=_loss_fn, mesh=_cpu_mesh(1),
                                axis="pod", n_micro=n_micro)
    assert loss.dtype == torch.float32 and loss.shape == ()
    _close(loss, loss_j)
    _close(grads, grads_j)
    ref_loss, ref_grads = _reference(layers, x, tgt, n_micro)
    _close(loss, ref_loss)
    _close(grads, ref_grads)


# ---------------------------------------------------------------------------
# Uneven StagePlans on CPU ranks against the non-pipelined reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ranks,n_layers,weights,n_micro", [
    (2, 5, {0: 2.0, 1: 1.0}, 3),
    (2, 4, {0: 3.0, 1: 1.0}, 4),
    (4, 8, {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}, 6),
    (4, 6, {0: 2.0, 1: 1.0, 2: 1.0, 3: 1.0}, 6),
    (4, 9, {0: 1.0, 1: 0.3, 2: 1.0, 3: 2.0}, 5),
])
def test_1f1b_uneven_plans_match_reference_on_cpu_ranks(n_ranks, n_layers, weights, n_micro):
    layers, x, tgt = _inputs(n_micro, n_layers, seed=n_layers)
    plan = StagePlan(n_layers=n_layers, weights=dict(weights))
    packed, mask = plan.pack(torch.from_numpy(layers))
    step = PipelineStep(_layer_fn, _loss_fn, mesh=_cpu_mesh(n_ranks), axis="pod",
                        n_micro=n_micro)
    loss, packed_grads = step(packed, torch.from_numpy(x), torch.from_numpy(tgt),
                              stage_mask=mask)
    ref_loss, ref_grads = _reference(layers, x, tgt, n_micro)
    _close(loss, ref_loss)
    _close(plan.unpack(packed_grads), ref_grads)
    # padded slots run nothing and receive exactly zero gradient
    assert not packed_grads[~mask].any()


def test_1f1b_integer_targets():
    """An int-target classification loss is legitimate (the reference's
    regression test), here on 2 CPU ranks."""
    n_micro = 4
    layers, x, _ = _inputs(n_micro, 4, seed=21)
    tgt = np.random.default_rng(4).integers(0, WIDTH, (n_micro * MICRO_BATCH,)).astype(np.int32)

    def nll_j(y, t):
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(y), t[:, None], axis=-1))

    def nll(y, t):
        return -torch.log_softmax(y, -1).gather(-1, t.long()[:, None]).mean()

    ref_loss, ref_grads = _reference(layers, x, tgt, n_micro, loss_fn=nll_j)
    for n_ranks in (1, 2):
        loss, grads = pipeline_step(_layer_fn, torch.from_numpy(layers), torch.from_numpy(x),
                                    torch.from_numpy(tgt), loss_fn=nll,
                                    mesh=_cpu_mesh(n_ranks), axis="pod", n_micro=n_micro)
        _close(loss, ref_loss)
        _close(grads, ref_grads)


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_phased_execution_equals_fused_and_times_phases(n_ranks):
    """warmup/steady/cooldown as three segments give the same bits as one,
    and the phase callback sees each non-empty phase exactly once."""
    n_micro = 4
    layers, x, tgt = (torch.from_numpy(a) for a in _inputs(n_micro, 2 * n_ranks, seed=2))
    fused = pipeline_step(_layer_fn, layers, x, tgt, loss_fn=_loss_fn,
                          mesh=_cpu_mesh(n_ranks), axis="pod", n_micro=n_micro)
    seen = []

    class _Phase:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(self.name)

        def __exit__(self, *exc):
            return False

    step = PipelineStep(_layer_fn, _loss_fn, mesh=_cpu_mesh(n_ranks), axis="pod",
                        n_micro=n_micro, phase_cb=_Phase)
    phased = step(layers, x, tgt)
    assert seen == [name for name, (t0, t1) in phase_ticks(n_micro, n_ranks).items() if t1 > t0]
    assert torch.equal(phased[0], fused[0]) and torch.equal(phased[1], fused[1])


def test_no_rank_stashes_more_than_the_ring():
    """Over every (S, M) with M up to 2S + 3 the forward never writes a
    stash slot whose input is still live (the step raises on a collision)
    and no rank ever holds more than min(2S, M) stage inputs — the 1F1B
    memory bound, sized by the depth, not by M."""
    for s in (1, 2, 3, 4, 5):
        for m in range(1, 2 * s + 4):
            layers, x, tgt = (torch.from_numpy(a) for a in _inputs(m, s, seed=s * 31 + m))
            step = PipelineStep(_layer_fn, _loss_fn, mesh=_cpu_mesh(s), axis="pod", n_micro=m)
            step(layers, x, tgt)
            assert 1 <= step.last_stash_peak <= min(2 * s, m), (s, m, step.last_stash_peak)
            if m >= 2 * s:
                assert step.last_stash_peak == 2 * s or s == 1


def test_restage_moves_boundaries_between_steps():
    """Mid-run restage (the reference's audit, on 2 CPU ranks): step under a
    padded uneven plan, update the live flat stack, re-pack under a plan
    whose max_depth shrank, then re-grow — each step's gradients match a
    fresh non-pipelined reference and padded slots get exactly zero."""
    n_micro = 3
    layers = _inputs(n_micro, 4, seed=41)[0]
    step = PipelineStep(_layer_fn, _loss_fn, mesh=_cpu_mesh(2), axis="pod", n_micro=n_micro)

    def run(plan, layers, seed):
        _, x, tgt = _inputs(n_micro, 4, seed=seed)
        ref_loss, ref_grads = _reference(layers, x, tgt, n_micro)
        packed, mask = plan.pack(torch.from_numpy(layers))
        loss, pg = step(packed, torch.from_numpy(x), torch.from_numpy(tgt), stage_mask=mask)
        _close(loss, ref_loss)
        grads = plan.unpack(pg)
        _close(grads, ref_grads)
        assert not pg[~mask].any()
        return layers - 0.1 * grads.numpy()

    plan_a = StagePlan(n_layers=4, weights={0: 3.0, 1: 1.0})
    assert plan_a.depths() == {0: 3, 1: 1} and plan_a.max_depth() == 3
    layers = run(plan_a, layers, seed=51)
    plan_b = StagePlan.equal(range(2), 4)
    assert plan_b.max_depth() == 2
    layers = run(plan_b, layers, seed=52)
    plan_c = StagePlan(n_layers=4, weights={0: 1.0, 1: 4.0})
    assert plan_c.depths() == {0: 1, 1: 3} and plan_c.max_depth() == 3
    run(plan_c, layers, seed=53)


# ---------------------------------------------------------------------------
# Validation: the reference's checks and messages
# ---------------------------------------------------------------------------


def test_pipeline_step_validation():
    mesh = _cpu_mesh(1)
    layers = torch.zeros((2, 2, WIDTH, WIDTH))
    x = torch.zeros((4, WIDTH))
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        pipeline_step(_layer_fn, layers, x, x, loss_fn=_loss_fn, mesh=mesh, axis="pod",
                      n_micro=3)
    with pytest.raises(ValueError, match=r"stage_mask shape \(3,\) != \(2,\)"):
        pipeline_step(_layer_fn, layers, x, x, loss_fn=_loss_fn, mesh=mesh, axis="pod",
                      n_micro=2, stage_mask=torch.ones((3,), dtype=torch.bool))
    with pytest.raises(ValueError, match="must preserve activation shape/dtype"):
        pipeline_step(lambda w, a: a[..., :4], layers, x, x, loss_fn=_loss_fn, mesh=mesh,
                      axis="pod", n_micro=2)
    with pytest.raises(ValueError, match="must return a scalar"):
        pipeline_step(_layer_fn, layers, x, x, loss_fn=lambda y, t: y - t, mesh=mesh,
                      axis="pod", n_micro=2)
    with pytest.raises(ValueError, match="targets leading dim 2 != batch 4"):
        pipeline_step(_layer_fn, layers, x, x[:2], loss_fn=_loss_fn, mesh=mesh, axis="pod",
                      n_micro=2)
    with pytest.raises(ValueError, match="must be a multiple of mesh axis 'pod' size 4"):
        pipeline_step(_layer_fn, layers, x, x, loss_fn=_loss_fn, mesh=_cpu_mesh(4),
                      axis="pod", n_micro=2)
    with pytest.raises(ValueError, match="disagree on the slot dimension"):
        pipeline_step(lambda w, a: a, {"a": layers, "b": layers[:1]}, x, x,
                      loss_fn=_loss_fn, mesh=mesh, axis="pod", n_micro=2)
    with pytest.raises(ValueError, match="pass both or neither"):
        PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=2,
                     first_fn=lambda p, t: t)
    with pytest.raises(ValueError, match="only be None when last_fn"):
        PipelineStep(_layer_fn, None, mesh=mesh, axis="pod", n_micro=2)
    with pytest.raises(ValueError, match="n_micro must be >= 1"):
        PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=0)
    # a stage spec may shard the slot dimension over the pipeline axis only
    with pytest.raises(NotImplementedError, match="not collective-aware"):
        PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=2,
                     stage_spec={"w": PartitionSpec("pod", None, "model")})
    with pytest.raises(ValueError, match="must be the pipeline axis 'pod'"):
        PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=2,
                     stage_spec=PartitionSpec("data"))
    assert PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=2,
                        stage_spec=PartitionSpec("pod")).stage_spec == ("pod",)
    hooked = PipelineStep(_layer_fn, None, mesh=mesh, axis="pod", n_micro=2,
                          first_fn=lambda p, t: t, last_fn=lambda p, y, t: _loss_fn(y, t))
    with pytest.raises(ValueError, match="first_params/last_params are required"):
        hooked(layers, x, x)
    with pytest.raises(ValueError, match="given but the step has no"):
        PipelineStep(_layer_fn, _loss_fn, mesh=mesh, axis="pod", n_micro=2)(
            layers, x, x, first_params={}, last_params={})


def test_stage_plan_validation_and_depths():
    plan = StagePlan.equal(range(4), 12)
    assert plan.depths() == {0: 3, 1: 3, 2: 3, 3: 3}
    plan.set_weight(2, 0.5)
    depths = plan.depths()
    assert sum(depths.values()) == 12 and depths[2] < 3
    assert min(depths.values()) >= 1
    cursor = 0
    for stage in plan.stages:
        start, stop = plan.boundaries()[stage]
        assert start == cursor and stop - start == depths[stage]
        cursor = stop
    assert cursor == 12
    with pytest.raises(ValueError, match="stage 9 is not in the plan"):
        plan.set_weight(9, 1.0)
    with pytest.raises(ValueError, match="weight must be positive"):
        plan.set_weight(0, 0.0)
    with pytest.raises(ValueError, match="cannot cover 5 stages"):
        StagePlan.equal(range(5), 4)
    with pytest.raises(ValueError, match="needs at least one stage"):
        StagePlan(n_layers=4, weights={})
    plan = StagePlan.equal(range(2), 4)
    with pytest.raises(ValueError, match="layer_params leaf has 3 layers, plan covers 4"):
        plan.pack(torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="packed leaf has 3 slots, plan packs to 4"):
        plan.unpack(torch.zeros((3, 2)))


def test_meshes_validate_and_split():
    mesh = _cpu_mesh(1)
    subs = pipeline_submeshes(mesh, "pod")
    assert len(subs) == 1 and subs[0].shape == {"pod": 1}
    grid = local_mesh((2, 3), ("pod", "model"), device="cpu")
    assert grid.shape == {"pod": 2, "model": 3} and grid.size == 6
    subs = pipeline_submeshes(grid, "pod")
    assert [s.axis_names for s in subs] == [("model",), ("model",)]
    assert [s.shape for s in subs] == [{"model": 3}] * 2
    with pytest.raises(ValueError, match="mesh has no axis 'nope'"):
        pipeline_submeshes(mesh, "nope")
    assert remove_host(grid, 1).shape == {"pod": 1, "model": 3}
    assert remove_host(grid, 0, "model").shape == {"pod": 2, "model": 2}
    with pytest.raises(ValueError, match="cannot lose its last slice"):
        remove_host(mesh, 0)
    with pytest.raises(ValueError, match=r"slice 5 out of range \[0, 3\)"):
        remove_host(grid, 5, "model")
    assert local_mesh((4,), ("pod",), device="cpu").devices.tolist() == [torch.device("cpu")] * 4
    assert meshutil.default_axis_names(3) == ("pod", "data", "model")
    assert local_mesh((1, 1), device="cpu").axis_names == ("data", "model")
    with pytest.raises(ValueError, match="no default axis names for a rank-4 mesh"):
        local_mesh((1, 1, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="does not match mesh_shape"):
        local_mesh((2,), ("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="non-empty positive ints"):
        local_mesh((0,), ("pod",), device="cpu")
    # a card mesh needs that many cards; sharing one is an explicit Mesh only
    want = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"needs {want} devices but only {want - 1} are visible"):
        local_mesh((want,), ("pod",), device="cuda")
    shared = Mesh([torch.device("cuda", 0)] * 4, ("pod",))
    assert shared.shape == {"pod": 4} and set(shared.devices.tolist()) == {torch.device("cuda", 0)}
    with pytest.raises(ValueError, match="do not match a 1-d device array"):
        Mesh(["cpu", "cpu"], ("pod", "model"))
