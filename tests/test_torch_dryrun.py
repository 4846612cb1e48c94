"""PyTorch port, the dry run (``repro_torch.launch.dryrun``): every cell's
step built and run once on CPU fake tensors in a ``fake`` process group, in
a subprocess that starts the group (as ``tests/test_dryrun_mini.py`` runs a
forced-8-device subprocess), so this process never joins one.

* The reference's mini matrix: the same four archs' smoke configs, a train
  and a decode cell each, on a (2, 2, 2) ("pod", "data", "model") mesh:
  every record ``"ok"``.
* ``state_bytes`` equal to the shard sizes the reference's ``spec_for``
  gives on a mesh of the same shape and names (params, optimizer state,
  cache), and, as a hypothesis property over random dims and mesh sizes,
  the dry run's shard arithmetic equal to the reference's spec's.
* Data-parallel identity: the llama smoke train cell's per-device FLOPs
  on a (1, 4, 1) mesh, times 4, equal the same cell's on one device,
  exactly (each rank counts its own shards' work).
* Collective bytes: none on a one-device mesh; for llama smoke decode on
  (1, 1, 2) the count worked out by hand below.
* Full-width cells that failed before the heads repair and the WKV-6
  boundary (llama3.2-1b and rwkv6-1.6b x train_4k on the single production
  mesh of 256 ranks): ``"ok"``.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.testing import given, settings, strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "recurrentgemma-9b", "rwkv6-1.6b")
FULL_CELLS = ("llama3.2-1b", "rwkv6-1.6b")

SCRIPT = r"""
import json, math, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import start_fake_group
from repro_torch.models.config import ShapeConfig

out_dir, mini, full = sys.argv[1], sys.argv[2].split(","), sys.argv[3].split(",")
out = {"mini": {}, "dp": {}, "full": {}}

def mesh_of(shape):
    start_fake_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))

def cell(arch, shape, mesh, label):
    return D.run_cell(arch, shape.name, True, smoke=True, mesh=mesh, mesh_label=label,
                      shape_override=shape, out_dir=out_dir, verbose=False)

train, decode = ShapeConfig("t", "train", 64, 8), ShapeConfig("d", "decode", 64, 8)
mesh = mesh_of((2, 2, 2))
for arch in mini:
    for shape in (train, decode):
        out["mini"][f"{arch}:{shape.kind}"] = cell(arch, shape, mesh, "mini")
for shape_mesh in ((1, 1, 1), (1, 4, 1), (1, 1, 2)):
    mesh = mesh_of(shape_mesh)
    for shape in (train, decode):
        out["dp"][f"{shape_mesh}:{shape.kind}"] = cell("llama3.2-1b", shape, mesh, "dp")
for arch in full:
    out["full"][arch] = D.run_cell(arch, "train_4k", False, out_dir=out_dir, verbose=False)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, out_dir, ",".join(MINI_ARCHS), ",".join(FULL_CELLS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), out_dir


def test_mini_matrix_cells_are_ok_and_written(dryrun):
    results, out_dir = dryrun
    assert sorted(results["mini"]) == sorted(f"{a}:{k}" for a in MINI_ARCHS
                                             for k in ("train", "decode"))
    for key, rec in results["mini"].items():
        assert rec["status"] == "ok", (key, rec)
        assert rec["n_chips"] == 8 and rec["scan_bodies"] == []
        assert rec["cost_analysis"]["flops"] > 0, key
        # a (2, 2, 2) mesh shards the batch and the heads: ranks talk
        assert sum(rec["collective_operand_bytes_per_device"].values()) > 0, key
        assert rec["memory_analysis"]["peak_bytes"] >= rec["memory_analysis"][
            "argument_size_in_bytes"] > 0
        name = f"{rec['arch']}__{rec['shape']}__mini.json"
        with open(os.path.join(out_dir, name)) as fh:
            assert json.load(fh) == rec


def _reference_bytes(arch, kind, sizes):
    """Per-device bytes of the reference's params (and optimizer state, or
    cache) under its own ``spec_for`` on a duck mesh of ``sizes``."""
    import jax
    import numpy as np

    from repro.configs import get_smoke_config
    from repro.dist import sharding as JS
    from repro.launch.steps import rules_for
    from repro.models import model as JM
    from repro.optim import AdamWConfig, init_opt_state, opt_state_axes

    class Duck:
        shape = sizes

    cfg = get_smoke_config(arch)
    rules = rules_for(cfg)

    def one(ax, leaf):
        shard = list(leaf.shape)
        for dim, entry in enumerate(JS.spec_for(ax, leaf.shape, Duck(), rules)):
            for axis in () if entry is None else (entry,) if isinstance(entry, str) else entry:
                shard[dim] //= sizes[axis]
        return int(np.prod(shard)) * np.dtype(leaf.dtype).itemsize

    def nbytes(axes, abstract):  # as the reference's tree_shardings walks the trees
        return sum(jax.tree.leaves(jax.tree.map(one, axes, abstract,
                                                is_leaf=lambda x: isinstance(x, JS.Axes))))

    p_axes, p_abs = JM.param_axes(cfg), JM.abstract_params(cfg)
    out = {"params_bytes_per_device": nbytes(p_axes, p_abs)}
    if kind == "train":
        opt = AdamWConfig()
        o_abs = jax.eval_shape(lambda p: init_opt_state(opt, p), p_abs)
        out["opt_bytes_per_device"] = nbytes(opt_state_axes(opt, p_axes), o_abs)
    else:
        out["cache_bytes_per_device"] = nbytes(JM.cache_axes(cfg, 8, 64),
                                               JM.abstract_cache(cfg, 8, 64))
    return out


def test_state_bytes_match_reference_spec_for(dryrun):
    results, _ = dryrun
    sizes = {"pod": 2, "data": 2, "model": 2}
    for key, rec in results["mini"].items():
        arch, kind = key.split(":")
        assert rec["state_bytes"] == _reference_bytes(arch, kind, sizes), key


AXES = (None, "batch", "seq", "embed", "heads", "kv_heads", "head_dim", "ffn", "expert",
        "vocab", "layers", "kv_seq")


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(1, 96), min_size=1, max_size=4),
       axes=st.lists(st.sampled_from(AXES), min_size=4, max_size=4),
       pod=st.sampled_from([1, 2, 4]), data=st.sampled_from([1, 2, 3, 4, 8]),
       model=st.sampled_from([1, 2, 4, 16]), fsdp=st.booleans())
def test_shard_bytes_property_matches_reference(dims, axes, pod, data, model, fsdp):
    import numpy as np
    import torch

    from repro.dist import sharding as JS
    from repro_torch.dist import sharding as S
    from repro_torch.launch.dryrun import _sharded_nbytes
    from repro_torch.models.layers import PSpec

    sizes = {"pod": pod, "data": data, "model": model}

    class Duck:
        shape = sizes

    ax = tuple(axes[:len(dims)])
    prules, jrules = (S.FSDP_RULES, JS.FSDP_RULES) if fsdp else (S.DEFAULT_RULES,
                                                                JS.DEFAULT_RULES)
    spec = PSpec(tuple(dims), ax, dtype=torch.bfloat16)
    got = _sharded_nbytes(spec, S.spec_for(ax, dims, Duck(), prules), sizes)
    shard = list(dims)
    for dim, entry in enumerate(JS.spec_for(ax, tuple(dims), Duck(), jrules)):
        for axis in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            shard[dim] //= sizes[axis]
    assert got == int(np.prod(shard)) * 2


def test_flops_per_device_are_each_ranks_own(dryrun):
    """The batch over 4 data ranks: each rank's matmul FLOPs are a quarter
    of one device's, exactly."""
    dp = dryrun[0]["dp"]
    one, four = dp["(1, 1, 1):train"], dp["(1, 4, 1):train"]
    assert one["status"] == four["status"] == "ok"
    assert four["cost_analysis"]["flops"] * 4 == one["cost_analysis"]["flops"] > 0
    assert dp["(1, 4, 1):decode"]["cost_analysis"]["flops"] * 4 == \
        dp["(1, 1, 1):decode"]["cost_analysis"]["flops"]


def test_collective_bytes_zero_on_one_device_and_counted_by_hand(dryrun):
    dp = dryrun[0]["dp"]
    for kind in ("train", "decode"):
        assert dp[f"(1, 1, 1):{kind}"]["collective_operand_bytes_per_device"] == {}
    # llama smoke decode, tensor-parallel over model = 2, batch 8, width 64,
    # bf16 (2 bytes), 2 layers: every (B, 1, D) partial sum is all-reduced
    # once — the vocabulary-parallel embedding lookup's, and each layer's
    # attention output projection's and MLP down projection's (row-parallel:
    # their inputs are split over the heads and the ffn); nothing else moves
    # (q/k/v, the K/V cache writes, the attention and the logits stay on
    # each rank's heads and vocabulary shard)
    b, d, layers, bf16 = 8, 64, 2, 2
    want = {"all-reduce": (1 + 2 * layers) * b * 1 * d * bf16}
    rec = dp["(1, 1, 2):decode"]
    assert rec["collective_operand_bytes_per_device"] == want, rec
    assert rec["op_census"]["all-reduce"] == 1 + 2 * layers


def test_full_width_train_cells_on_the_production_mesh(dryrun):
    """Two KV heads... eight over the 16-way model axis (llama3.2-1b) and
    the chunked WKV-6 on a strided batch shard (rwkv6-1.6b) failed before."""
    for arch, rec in dryrun[0]["full"].items():
        assert rec["status"] == "ok", (arch, rec)
        assert rec["n_chips"] == 256 and rec["mesh"] == "single"
        assert rec["state_bytes"]["params_bytes_per_device"] > 0
        assert rec["op_census"].get("flash_fwd", 0) + rec["op_census"].get("rmsnorm_fwd", 0) > 0
