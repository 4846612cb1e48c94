"""PyTorch port, logical-axis sharding: ``dist.sharding.spec_for`` against the
reference's ``spec_for`` on every logical-axes tuple of every config's
parameters and decode cache (smoke and full width, abstract only) under both
rule tables at the production mesh shapes and small ones, ``param_axes`` and
``stage_param_specs`` against the reference's tree for tree, the port's
copies of ``tests/test_sharding.py``'s cases, ``placements_for`` and the
ambient context (``constrain`` is a no-op outside ``use_sharding`` and on
plain tensors inside it).

The reference's ``spec_for`` reads only ``dict(mesh.shape)``
(``src/repro/dist/sharding.py``), so one duck-typed mesh serves both
packages without a device of the production mesh's size.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.dist import sharding as JS
from repro.models import model as JM
from repro.models import pipeline as JMP
from repro.models.layers import is_pspec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sharding as S
from repro_torch.dist.context import constrain, current_sharding, use_sharding
from repro_torch.dist.meshutil import local_mesh
from repro_torch.models import model as PM
from repro_torch.models import pipeline as PMP
from repro_torch.models.layers import tree_leaves, tree_map

MESHES = {
    "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
    "data16_model16": {"data": 16, "model": 16},
    "data2_model2": {"data": 2, "model": 2},
    "data4_model1": {"data": 4, "model": 1},
}
RULES = (("tp", JS.DEFAULT_RULES, S.DEFAULT_RULES), ("tp+fsdp", JS.FSDP_RULES, S.FSDP_RULES))
CONFIGS = [(arch, smoke) for arch in ARCH_IDS for smoke in (True, False)]
CACHE_BATCH, CACHE_SEQ = 8, 256


class DuckMesh:
    """What both packages' ``spec_for`` read of a mesh: ``.shape``, a dict."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


class DuckDeviceMesh:
    """What ``placements_for`` reads of a DeviceMesh."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _configs(arch, smoke):
    return ((jax_smoke_config if smoke else jax_config)(arch),
            (get_smoke_config if smoke else get_config)(arch))


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=is_pspec)


def _spec(p):
    """A reference ``PartitionSpec`` as the port's tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def _normalize(tree):
    """Nested python of an axes/spec tree: dicts, tuples, leaves as tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _normalize(v) for k, v in tree.items()}
    if isinstance(tree, (S.Axes, JS.Axes, JP, S.PartitionSpec)):
        return ("leaf",) + _spec(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_normalize(v) for v in tree)
    raise TypeError(type(tree))


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_spec_for_matches_reference_on_every_param_and_cache_leaf(arch, smoke):
    jcfg, _ = _configs(arch, smoke)
    leaves = _jax_leaves(JM.model_specs(jcfg))
    leaves += _jax_leaves(JM.cache_specs(jcfg, CACHE_BATCH, CACHE_SEQ))
    cases = 0
    for sizes in MESHES.values():
        mesh = DuckMesh(sizes)
        for _, jrules, prules in RULES:
            for leaf in leaves:
                want = _spec(JS.spec_for(leaf.axes, leaf.shape, mesh, jrules))
                got = S.spec_for(leaf.axes, leaf.shape, mesh, prules)
                assert tuple(got) == want, (leaf.axes, leaf.shape, sizes, got, want)
                cases += 1
    assert cases == len(leaves) * len(MESHES) * len(RULES)


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_param_axes_match_reference_tree_for_tree(arch, smoke):
    jcfg, pcfg = _configs(arch, smoke)
    ours = PM.param_axes(pcfg)
    assert all(isinstance(ax, S.Axes) for ax in tree_leaves(ours))
    assert _normalize(ours) == _normalize(JM.param_axes(jcfg))
    # abstract_params: the same shapes, leaf for leaf, in the axes' tree
    shapes = tree_map(lambda ax, spec: S.Axes(spec.shape), ours, PM.abstract_params(pcfg))
    ref = jax.tree.map(lambda s: JS.Axes(s.shape), JM.abstract_params(jcfg))
    assert _normalize(shapes) == _normalize(ref)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b", "rwkv6-1.6b"])
@pytest.mark.parametrize("mesh_name", ["pod4", "pod2_data16_model16"])
@pytest.mark.parametrize("rules_name", ["tp", "tp+fsdp"])
def test_stage_param_specs_match_reference(arch, mesh_name, rules_name):
    sizes = {"pod4": {"pod": 4}, "pod2_data16_model16": MESHES["pod2_data16_model16"]}[mesh_name]
    _, jrules, prules = dict((r[0], r) for r in RULES)[rules_name]
    mesh = DuckMesh(sizes)
    for smoke in (True, False):
        jcfg, pcfg = _configs(arch, smoke)
        want = JMP.stage_param_specs(jcfg, mesh, jrules, "pod")
        got = PMP.stage_param_specs(pcfg, mesh, prules, "pod")
        assert _normalize(got) == _normalize(want)
        if mesh_name == "pod4":  # every inner entry drops on a pod-only mesh
            assert {tuple(s) for s in tree_leaves(got)} == {("pod",)}


# ---- the port's copies of tests/test_sharding.py ----------------------------

@pytest.fixture(scope="module")
def mesh():
    return local_mesh((1, 1), ("data", "model"), device="cpu")


def test_spec_basic(mesh):
    assert S.spec_for(("embed", "heads"), (64, 32), mesh, S.DEFAULT_RULES) == (None, "model")


def test_axis_absent_from_mesh_dropped(mesh):
    assert S.spec_for(("batch", "seq"), (8, 16), mesh, S.DEFAULT_RULES) == ("data",)


def test_divisibility_drop(mesh):
    rules = S.ShardingRules({"kv_heads": "model"})
    assert S.spec_for(("kv_heads",), (2,), mesh, rules) == ("model",)
    # a model axis of 16 does not divide 2 KV heads: dropped
    assert S.spec_for(("kv_heads",), (2,), DuckMesh({"model": 16}), rules) == ()


def test_axis_used_once_per_tensor(mesh):
    rules = S.ShardingRules({"a": "model", "b": "model"})
    assert S.spec_for(("a", "b"), (4, 4), mesh, rules) == ("model",)


def test_multi_axis_dim(mesh):
    rules = S.ShardingRules({"batch": ("data", "model")})
    assert S.spec_for(("batch", None), (4, 4), mesh, rules) == (("data", "model"),)


def test_fsdp_rules_shard_embed(mesh):
    assert S.spec_for(("embed", "ffn"), (64, 128), mesh, S.FSDP_RULES) == ("data", "model")


def test_tree_shardings_with_axes_leaves(mesh):
    axes = {"w": S.Axes(("embed", "heads")), "scalar": S.Axes(()), "empty": ()}
    shapes = {"w": torch.empty(8, 4), "scalar": torch.empty(()), "empty": ()}
    specs = S.tree_shardings(axes, shapes, mesh, S.DEFAULT_RULES)
    assert specs["w"] == (None, "model") and specs["scalar"] == () and specs["empty"] == ()


def test_mismatched_rank_raises(mesh):
    with pytest.raises(ValueError, match="rank mismatch"):
        S.spec_for(("embed",), (4, 4), mesh, S.DEFAULT_RULES)


def test_rules_overrides():
    r = S.DEFAULT_RULES.with_overrides(seq="data")
    assert r.get("seq") == ("data",)
    assert S.DEFAULT_RULES.get("seq") == ()
    assert r != S.DEFAULT_RULES and r == S.DEFAULT_RULES.with_overrides(seq=("data",))
    assert S.FSDP_RULES == S.DEFAULT_RULES.with_overrides(embed="data")


def test_rule_tables_match_reference_entry_for_entry():
    for _, jrules, prules in RULES:
        assert dict(prules.items()) == dict(jrules.items())


# ---- placements and the ambient context --------------------------------------

def test_placements_for_orders_shards_by_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    dm = DuckDeviceMesh({"pod": 2, "data": 2, "model": 2})
    assert S.placements_for(S.PartitionSpec(("pod", "data"), None, "model"), dm) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements_for(S.PartitionSpec(), dm) == (Replicate(),) * 3
    spec = S.spec_for(("embed", "heads"), (64, 32), dm, S.FSDP_RULES)
    assert S.placements_for(spec, dm) == (Replicate(), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        S.placements_for(S.PartitionSpec("expert"), dm)
    # the port's Mesh reads the same way
    assert S.mesh_sizes(local_mesh((1, 1), device="cpu")) == {"data": 1, "model": 1}


def test_constrain_is_a_noop_outside_a_context_and_on_plain_tensors(mesh):
    x = torch.randn(4, 8)
    assert current_sharding() is None
    assert constrain(x, "batch", None) is x
    with use_sharding(mesh, S.DEFAULT_RULES):
        assert current_sharding() == (mesh, S.DEFAULT_RULES)
        assert constrain(x, "batch", None) is x
        with use_sharding(mesh, S.FSDP_RULES):  # nestable
            assert current_sharding()[1] == S.FSDP_RULES
        assert current_sharding()[1] == S.DEFAULT_RULES
    assert current_sharding() is None


def test_axes_are_tree_leaves():
    tree = {"a": S.Axes(("embed", None)), "b": (S.Axes(()), None)}
    assert tree_leaves(tree) == [("embed", None), ()]
    assert tree_map(len, tree) == {"a": 2, "b": (0, None)}
    assert PM.cache_axes(get_smoke_config("llama3.2-1b"), 2, 16)["scan"][0]["k"] == S.Axes(
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"))
    np.testing.assert_equal(len(tree_leaves(PM.param_axes(get_smoke_config("llama3.2-1b")))),
                            len(tree_leaves(PM.model_specs(get_smoke_config("llama3.2-1b")))))
