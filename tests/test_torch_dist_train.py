"""PyTorch port, sharded training across real processes on the CPU: a
("data", "model") DeviceMesh of (2, 2) gloo ranks (``dist.spawn.run_ranks``,
a ``file://`` rendezvous in a temporary directory, so concurrent runs never
share a port), the parameters, optimizer state and batch as DTensors laid
out by the config's logical axes (``dist.sharding.distribute_tree``), and
the flash and RMSNorm wrappers (their plain versions here) on each rank's
local shards.

Each case holds the sharded step against the port's unsharded step on the
same seed, parameters and batch, in f32 at the smoke width: three AdamW
steps' losses, every leaf of the first step's gradient (gathered) and every
parameter after the third step, each to 1e-5 relative.  The cases: the
llama smoke config under "tp" and "tp+fsdp", the moonshot smoke config
(MoE) under each ``moe_dispatch_mode``; a checkpoint saved by
``run_training`` on (2, 2) resumed on (2, 2) and on (1, 1), whose losses
continue the unsharded run's; and a mesh of one rank, which must stay bit
for bit the unsharded path.  Every mesh spawns once, in a module-scoped
fixture; the checks read its results.
"""

import dataclasses
import math
import os
import shutil

import pytest
import torch

from repro_torch.dist.spawn import run_ranks

SEQ, BATCH, STEPS, RTOL = 64, 4, 3, 1e-5
STEP_CASES = {  # name: (arch, sharding preset, moe_dispatch_mode)
    "llama_tp": ("llama3.2-1b", "tp", "embed"),
    "llama_tp_fsdp": ("llama3.2-1b", "tp+fsdp", "embed"),
    "moonshot_tokens": ("moonshot-v1-16b-a3b", "tp", "tokens"),
    "moonshot_embed": ("moonshot-v1-16b-a3b", "tp+fsdp", "embed"),
}
RESUME_SEQ, RESUME_STEPS, RESUME_AT = 32, 4, 2


def _fresh_registries():
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    reset_timer_db()
    reset_param_registry()
    reset_default_clocks()


def _cfg(arch, preset="tp", mode="embed"):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(
        attn_impl="pallas", norm_impl="fused", remat="dots", dtype="float32",
        sharding=preset, moe_dispatch_mode=mode)


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _step_case(mesh, arch, preset, mode):
    """(losses unsharded, losses sharded, worst gradient leaf, worst param)."""
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.context import use_sharding
    from repro_torch.dist.sharding import Axes, distribute_tree, gather_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = _cfg(arch, preset, mode)
    rules = ST.rules_for(cfg)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, SEQ, BATCH, mode="copy", seed=0),
                       arch=cfg)
    batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
               for i in range(STEPS)]
    in_axes = {k: Axes(v) for k, v in ST.batch_axes(cfg, "train").items()}
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sched = dict(warmup_steps=1, total_steps=10)

    plain_grads, _ = ST._grads(cfg, params, batches[0])
    plain = ST.make_train_step(cfg, shape, **sched)
    p, st, losses = params, init_opt_state(AdamWConfig(), params), []
    for b in batches:
        p, st, m = plain.fn(p, st, b)
        losses.append(float(m["loss"]))

    sp = distribute_tree(params, M.param_axes(cfg), mesh, rules)
    with use_sharding(mesh, rules):
        g, _ = ST._grads(cfg, sp, distribute_tree(batches[0], in_axes, mesh, rules))
        g = tree_map(lambda gg, q: gg.redistribute(q.device_mesh, q.placements), g, sp)
    grad_err = max(_rel(a, b) for a, b in zip(tree_leaves(gather_tree(g)),
                                              tree_leaves(plain_grads)))
    sharded = ST.make_train_step(cfg, shape, mesh=mesh, rules=rules, **sched)
    q, qst, sharded_losses = sp, init_opt_state(AdamWConfig(), sp), []
    for b in batches:
        q, qst, m = sharded.fn(q, qst, distribute_tree(b, in_axes, mesh, rules))
        assert all(not hasattr(v, "placements") for v in m.values())  # plain metrics
        sharded_losses.append(float(m["loss"]))
    param_err = max(_rel(a, b) for a, b in zip(tree_leaves(gather_tree(q)), tree_leaves(p)))
    # each leaf's placements on (data, model): "R", or "S" and the dim
    placements = sorted({tuple("S%d" % pl.dim if pl.is_shard() else "R" for pl in x.placements)
                         for x in tree_leaves(q)})
    return losses, sharded_losses, grad_err, param_err, placements


def _losses(path):
    import json

    with open(path) as fh:
        return [json.loads(line)["extra"]["loss"] for line in fh if line.strip()]


def _train(root, name, *, steps, mesh_shape, ckpt=None):
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.timing import TimingSession

    _fresh_registries()
    settings = TrainSettings(
        arch="llama3.2-1b", smoke=True, steps=steps, global_batch=BATCH,
        seq_len=RESUME_SEQ, seed=0, report_every=0, device="cpu",
        log_path=os.path.join(root, f"{name}.jsonl"), lr_total_steps=RESUME_STEPS,
        ckpt_dir=ckpt, ckpt_mode="fixed" if ckpt else "off", ckpt_every=1000,
        mesh_shape=mesh_shape)
    summary = run_training(settings, cfg=_cfg("llama3.2-1b", "tp+fsdp"), session=TimingSession())
    return summary


def _resume_case(rank, root):
    """run_training on (2, 2) saves at label RESUME_AT; copies of the
    checkpoint resume on (2, 2) and (1, 1); rank 0 also trains unsharded."""
    import torch.distributed as dist

    summary = _train(root, "saved", steps=RESUME_AT, mesh_shape=(2, 2),
                     ckpt=os.path.join(root, "ckpt"))
    dist.barrier()
    if rank == 0:
        for copy in ("on22", "on11"):
            shutil.copytree(os.path.join(root, "ckpt"), os.path.join(root, copy))
    dist.barrier()
    _train(root, "resumed22", steps=RESUME_STEPS, mesh_shape=(2, 2),
           ckpt=os.path.join(root, "on22"))
    if rank == 0:
        _train(root, "resumed11", steps=RESUME_STEPS, mesh_shape=(1, 1),
               ckpt=os.path.join(root, "on11"))
        _train(root, "unsharded", steps=RESUME_STEPS, mesh_shape=(1, 1))
    dist.barrier()
    out = {"mesh": summary["mesh"]}
    if rank == 0:
        out.update({name: _losses(os.path.join(root, f"{name}.jsonl"))
                    for name in ("saved", "resumed22", "resumed11", "unsharded")})
        out["saved_labels"] = sorted(os.listdir(os.path.join(root, "ckpt")))
    else:  # rank 0 alone writes logs and checkpoints
        out["wrote"] = [n for n in os.listdir(root) if n.startswith(f"rank{rank}")]
    return out


def _mesh22_worker(rank, world, root):
    from repro_torch.dist.meshutil import device_mesh

    torch.set_num_threads(1)
    mesh = device_mesh((2, 2), ("data", "model"), device="cpu")
    out = {name: _step_case(mesh, *case) for name, case in STEP_CASES.items()}
    out["resume"] = _resume_case(rank, root)
    return out


def _mesh1_worker(rank, world):
    """A one-rank DeviceMesh: the step must be the unsharded step, bit for bit."""
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state

    torch.set_num_threads(1)
    mesh = device_mesh((1, 1), ("data", "model"), device="cpu")
    cfg = _cfg("llama3.2-1b")
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, SEQ, BATCH, mode="copy", seed=0),
                       arch=cfg)
    results = []
    for m in (None, mesh):
        step = ST.make_train_step(cfg, shape, warmup_steps=1, total_steps=10, mesh=m)
        p = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        st = init_opt_state(AdamWConfig(), p)
        for i in range(STEPS):
            b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
            p, st, metrics = step.fn(p, st, b)
        results.append((float(metrics["loss"]), tree_leaves(p)))
    (loss_a, leaves_a), (loss_b, leaves_b) = results
    return {"loss": (loss_a, loss_b),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))}


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh22"))
    return run_ranks(_mesh22_worker, 4, root)


@pytest.fixture(scope="module")
def mesh1():
    return run_ranks(_mesh1_worker, 1)[0]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_matches_unsharded(mesh22, case):
    losses, sharded, grad_err, param_err, _ = mesh22[0][case]
    for a, b in zip(sharded, losses):
        assert abs(a - b) <= RTOL * abs(b), (sharded, losses)
    assert grad_err < RTOL, grad_err
    assert param_err < RTOL, param_err
    # every rank computed the same losses
    assert all(r[case][1] == sharded for r in mesh22)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_params_are_laid_out_by_the_rules(mesh22, case):
    placements = [tuple(p) for p in mesh22[0][case][4]]
    preset = STEP_CASES[case][1]
    # heads/ffn/experts/vocab over "model" in both presets; the width over
    # "data" under fsdp only (the norms stay replicated)
    assert any(model != "R" for _, model in placements), placements
    assert ("R", "R") in placements, placements
    assert any(data != "R" for data, _ in placements) == (preset == "tp+fsdp"), placements


def test_checkpoint_saved_on_2x2_resumes_on_2x2_and_1x1(mesh22):
    r = mesh22[0]["resume"]
    assert r["saved_labels"] == [f"step_{RESUME_AT:08d}"], r["saved_labels"]
    ref = r["unsharded"]
    assert len(ref) == RESUME_STEPS and len(r["saved"]) == RESUME_AT
    for name, got in (("saved", r["saved"]), ("resumed22", r["resumed22"]),
                      ("resumed11", r["resumed11"])):
        want = ref[:RESUME_AT] if name == "saved" else ref[RESUME_AT:]
        assert len(got) == len(want), (name, got)
        for a, b in zip(got, want):
            assert math.isclose(a, b, rel_tol=RTOL), (name, got, want)


def test_sharded_run_reports_its_mesh_and_rank0_alone_writes(mesh22):
    for rank, result in enumerate(mesh22):
        mesh = result["resume"]["mesh"]
        assert mesh["rank"] == rank and mesh["shape"] == (2, 2)
        assert mesh["axes"] == ("data", "model") and mesh["backend"] == "gloo"
        assert mesh["collective_calls"]["all_reduce"] > 0
        assert mesh["collective_seconds"]["all_reduce"] > 0
    assert all("saved" not in r["resume"] for r in mesh22[1:])


def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(mesh1):
    assert mesh1["loss"][0] == mesh1["loss"][1]
    assert mesh1["bit_equal"]


def test_run_ranks_fails_with_the_failing_rank():
    with pytest.raises(Exception, match="rank 1 says no"):
        run_ranks(_failing_worker, 2)


def _failing_worker(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 says no")
    dist.barrier()


def test_dataclass_settings_default_to_one_rank():
    from repro_torch.launch.train import TrainSettings

    s = TrainSettings()
    assert s.mesh_shape == (1, 1) and not s.allow_shared_card
    assert dataclasses.replace(s, mesh_shape=(2, 2)).mesh_shape == (2, 2)
