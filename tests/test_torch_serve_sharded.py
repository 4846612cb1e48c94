"""PyTorch port, sharded serving across real processes on the CPU: the six
families' smoke configs prefilled and decoded on a ("data", "model")
DeviceMesh of 4 gloo ranks, (2, 2) and (1, 4), through the step builders
(``launch.steps.make_prefill_step`` / ``make_serve_step``), the kernels'
plain versions on each rank's local shards (``seq_impl="pallas"``: the
recurrences through their kernel boundary too).

Each rank draws the same weights and prompts from one seed, runs the
unsharded port, then the sharded steps, which lay params, batch and cache
out by their logical axes; the gathered logits of the prefill and of four
decode steps, and the gathered cache after them, must equal the unsharded
port's to 1e-5 relative (f32).  Every family runs under its smoke
config's preset ("tp"), llama and recurrentgemma under "tp+fsdp" too.
The unsharded port is held to the
reference's ``M.prefill`` / ``M.decode_step`` on the same bridged weights
at the f32 tolerance of the port's serving tests (2e-4).  Also:
``input_specs`` against the reference's for every arch x shape cell, and
the recurrences' local boundary on DTensors against the plain tensor.
Every mesh spawns once, in a module-scoped fixture; the checks read its
results.  Spawned ranks import this module, so JAX is imported inside the
tests only.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import run_ranks

ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "recurrentgemma-9b", "rwkv6-1.6b",
         "internvl2-26b", "seamless-m4t-large-v2")
#: case: (arch, sharding preset): every family under its smoke config's
#: own ("tp"), and two under "tp+fsdp" (the width over "data", gathered
#: for compute)
CASES = {**{arch: (arch, "tp") for arch in ARCHS},
         "llama3.2-1b/fsdp": ("llama3.2-1b", "tp+fsdp"),
         "recurrentgemma-9b/fsdp": ("recurrentgemma-9b", "tp+fsdp")}
BATCH, PROMPT, DECODE_STEPS, RTOL, JAX_TOL = 4, 24, 4, 1e-5, 2e-4
MAX_SEQ = PROMPT + DECODE_STEPS + 4


def _cfg(arch, preset="tp"):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused",
                                          seq_impl="pallas", dtype="float32", sharding=preset)


def _inputs(cfg):
    """The prompt batch and the decode tokens, from one numpy seed."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + DECODE_STEPS), dtype=np.int32)
    batch = {"tokens": tokens[:, :PROMPT]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (BATCH, cfg.n_vision_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_frames"] = (0.02 * rng.standard_normal(
            (BATCH, PROMPT - 4, cfg.d_model))).astype(np.float32)
    steps = [tokens[:, t:t + 1] for t in range(PROMPT, PROMPT + DECODE_STEPS)]
    return batch, steps


def _max_seq(cfg):
    from repro_torch.models import model as M

    return M.prefix_positions(cfg) + MAX_SEQ


def _unsharded(cfg, params, batch, steps):
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, BATCH, _max_seq(cfg), device="cpu")
    with torch.no_grad():
        cache, last = M.prefill(cfg, params, batch, cache)
        logits = [last]
        for tok in steps:
            cache, lg = M.decode_step(cfg, params, cache, tok)
            logits.append(lg)
    return logits, cache


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _family_case(mesh, arch, preset):
    """(worst logits error, worst cache-leaf error, every cache leaf a
    DTensor laid out by cache_axes, the rank's local cache bytes)."""
    from repro_torch.dist.context import is_dtensor
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import tree_leaves

    cfg = _cfg(arch, preset)
    rules = ST.rules_for(cfg)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch_np, steps_np = _inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    steps = [torch.from_numpy(t) for t in steps_np]
    want, want_cache = _unsharded(cfg, params, batch, steps)

    prefill = ST.make_prefill_step(cfg, mesh, rules, ShapeConfig("p", "prefill", PROMPT, BATCH))
    serve = ST.make_serve_step(cfg, mesh, rules, ShapeConfig("d", "decode", MAX_SEQ, BATCH))
    cache, last = prefill.fn(params, batch, M.init_cache(cfg, BATCH, _max_seq(cfg), "cpu"))
    got = [last]
    for tok in steps:
        cache, lg = serve.fn(params, cache, tok)
        got.append(lg)
    laid_out = all(is_dtensor(x) for x in tree_leaves(cache))
    local_bytes = sum(x.to_local().numel() * x.element_size() for x in tree_leaves(cache))
    logits_err = max(_rel(g.full_tensor(), w) for g, w in zip(got, want))
    full = gather_tree(cache)
    cache_err = max(_rel(a.float(), b.float()) if b.is_floating_point() else
                    float(not torch.equal(a, b))
                    for a, b in zip(tree_leaves(full), tree_leaves(want_cache)))
    return logits_err, cache_err, laid_out, local_bytes


def _mesh_worker(rank, world, shape):
    from repro_torch.dist.meshutil import device_mesh

    torch.set_num_threads(1)
    mesh = device_mesh(shape, ("data", "model"), device="cpu")
    return {name: _family_case(mesh, *case) for name, case in CASES.items()}


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)], ids=["mesh22", "mesh14"])
def sharded(request):
    return request.param, run_ranks(_mesh_worker, 4, request.param)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_prefill_and_decode_match_unsharded(sharded, case):
    shape, results = sharded
    for rank, result in enumerate(results):
        logits_err, cache_err, laid_out, _ = result[case]
        assert laid_out, (shape, rank, case)
        assert logits_err < RTOL, (shape, rank, case, logits_err)
        assert cache_err < RTOL, (shape, rank, case, cache_err)
    # every rank holds its own shard of the cache, as its specs split it
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch.dryrun import _sharded_nbytes
    from repro_torch.launch.steps import rules_for
    from repro_torch.models import model as M

    cfg = _cfg(*CASES[case])
    sizes = dict(zip(("data", "model"), shape))
    specs = M.cache_specs(cfg, BATCH, _max_seq(cfg))
    parts = tree_shardings(M.cache_axes(cfg, BATCH, _max_seq(cfg)), specs, _Sizes(sizes),
                           rules_for(cfg))
    want = _sharded_nbytes(specs, parts, sizes)
    assert [r[case][3] for r in results] == [want] * len(results)


class _Sizes:
    """What ``spec_for`` reads of a mesh: ``.shape``, a dict."""

    def __init__(self, sizes):
        self.shape = sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_port_matches_reference(arch):
    """The port's prefill and decode steps against the reference's on the
    same bridged weights and inputs (f32)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import model as JM
    from repro_torch.bridge import to_torch

    cfg = _cfg(arch)
    cfg_j = jax_smoke_config(arch).replace(dtype="float32")
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    params = to_torch(jax.tree.map(np.asarray, params_j))
    batch_np, steps_np = _inputs(cfg)
    got, _ = _unsharded(cfg, params, {k: torch.from_numpy(v) for k, v in batch_np.items()},
                        [torch.from_numpy(t) for t in steps_np])
    cache_j = JM.init_cache(cfg_j, BATCH, _max_seq(cfg))
    cache_j, last_j = JM.prefill(cfg_j, params_j, {k: jnp.asarray(v) for k, v in batch_np.items()},
                                 cache_j)
    want = [last_j]
    for tok in steps_np:
        cache_j, lg = JM.decode_step(cfg_j, params_j, cache_j, jnp.asarray(tok))
        want.append(lg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), atol=JAX_TOL,
                                   rtol=JAX_TOL)


def test_input_specs_match_reference():
    """Shape and dtype of every input stand-in of every arch x shape cell
    (the port's encdec cache has one more leaf, ``xlen``)."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.launch import steps as JST
    from repro.models.config import SHAPES as JSHAPES
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import SHAPES
    from repro_torch.models.layers import tree_leaves

    assert list(SHAPES) == list(JSHAPES)

    def named(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in named(v, f"{prefix}/{k}")]
        if isinstance(tree, (tuple, list)):
            return [x for i, v in enumerate(tree) for x in named(v, f"{prefix}/{i}")]
        return [] if tree is None else [(prefix, tree)]

    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            got = dict(named(ST.input_specs(get_config(arch), shape)))
            want = dict(named(JST.input_specs(jax_config(arch), JSHAPES[name])))
            extra = {k for k in got if k.endswith("/xlen")}
            assert set(got) - extra == set(want), (arch, name, set(got) ^ set(want))
            for key, spec in want.items():
                dtype = str(jax.numpy.dtype(spec.dtype))
                assert tuple(got[key].shape) == tuple(spec.shape), (arch, name, key)
                assert str(got[key].dtype).removeprefix("torch.") == dtype, (arch, name, key)
            assert len(tree_leaves(got)) == len(got)


def _boundary_worker(rank, world):
    """The recurrences' kernel boundary on DTensors laid out as a sharded
    prefill lays them out (batch over "data", channels or heads over
    "model"; the sequence sharded too, which the boundary gathers) against
    the plain tensors, on every rank."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.sharding import local_shard
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.models import blocks

    torch.set_num_threads(1)
    mesh = device_mesh((2, 2), ("data", "model"), device="cpu")
    g = torch.Generator().manual_seed(3)
    b, s, d, h, k = 4, 12, 8, 4, 4
    a = torch.rand((b, s, d), generator=g) * 0.9 + 0.05
    x = torch.randn((b, s, d), generator=g)
    h0 = torch.randn((b, d), generator=g)
    dt = lambda t, pl: DTensor.from_local(  # noqa: E731
        local_shard(t, mesh, pl), mesh, pl, run_check=False)
    out = {}
    for impl in ("ref", "assoc", "pallas"):
        ys, hs = blocks._local_recurrence(impl, dt(a, (Shard(1), Shard(2))),
                                          dt(x, (Shard(0), Shard(2))), dt(h0, (Shard(0), Shard(1))))
        y, hn = rg.linear_recurrence(a, x, h0, impl=impl)
        out[f"rglru/{impl}"] = max(_rel(ys.full_tensor(), y), _rel(hs.full_tensor(), hn))
    r, kk, v = (torch.randn((b, s, h, k), generator=g) for _ in range(3))
    w = torch.rand((b, s, h, k), generator=g) * 0.5 + 0.45
    u = torch.randn((h, k), generator=g)
    st = torch.randn((b, h, k, k), generator=g)
    pl = (Shard(0), Shard(2))
    for impl in ("ref", "chunked", "pallas"):
        ys, ss = blocks._local_wkv6(impl, dt(r, pl), dt(kk, (Shard(1), Shard(2))), dt(v, pl),
                                    dt(w, pl), dt(u, (Shard(1), Shard(0))),
                                    dt(st, (Shard(0), Shard(1))))
        y, sn = wk.wkv6(r, kk, v, w, u, st, impl=impl)
        out[f"wkv6/{impl}"] = max(_rel(ys.full_tensor(), y), _rel(ss.full_tensor(), sn))
    return out


def test_recurrence_boundary_on_dtensors_matches_plain():
    for result in run_ranks(_boundary_worker, 4):
        for case, err in result.items():
            assert err < RTOL, (case, err)
