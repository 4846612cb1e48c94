"""PyTorch port, the 1F1B pipeline with one process a rank, on the CPU:
gloo processes (``dist.spawn.run_ranks``, a ``file://`` rendezvous in a
temporary directory) on a 1-d ``("pod",)`` ``DeviceMesh``, each holding only
its stage's units and pinned pieces, the rings as point-to-point messages
(``dist.p2p``), at smoke width in f32.

Each case holds the processes against the single controller
(``PipelineStep`` on a ``Mesh`` of CPU ranks in this process) from the same
weights and batch, bit for bit: the residual-MLP stack on 2 and 4 processes
under even and uneven plans with M in {1, S, 2S + 1} (loss and per-unit
gradients; each rank's stash at most min(2S, M), 2(S - 1)M ring messages a
step); the llama3.2-1b and rwkv6-1.6b smoke transformers on 2 processes
(loss and every gradient leaf, also within 2e-4 of ``jax.value_and_grad``
of the reference's ``loss_fn``, never its 1F1B, which fails under this
container's jax); one AdamW step (each rank's leaves, the two copies of the
tied table identical); a restage between steps, which moves units with
their ``master``, ``m`` and ``v``.  The launcher: ``run_training`` on 2
processes gives the single controller's losses (its runs in a fresh
process at one thread, as each rank's); a 4-process save restores
on 2 processes and on the single controller, and a single-controller save
on 4 processes; a restage decided on rank 0 runs on every rank at the same
step; and ``pipeline_stages`` other than the world size raises.  Each world
spawns once, in a module-scoped fixture; the checks read its results.
Spawned ranks import this module, so JAX is imported inside tests only.
"""

import json
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import run_ranks

MLP_LAYERS, MLP_WIDTH, MLP_SEQ, MLP_VOCAB = 8, 8, 8, 32
PLANS = ("even", "uneven")
SEQ, BATCH, MICRO = 128, 4, 2          # the transformers against JAX
CLIP = 0.5                              # their clip norm: below both gradients' norms
TRAIN = dict(steps=4, batch=8, seq=32, micro=4, at=2)  # the launcher runs
RESTAGE_AT = 1                          # the launcher's restage: after step 1


def _fresh_registries():
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    reset_timer_db()
    reset_param_registry()
    reset_default_clocks()


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _fresh_registries()
    yield
    _fresh_registries()
    torch.set_num_threads(threads)


def _weights(plan, world):
    return {r: 1.0 + (r if plan == "uneven" else 0) for r in range(world)}


def _mlp_cases(world):
    return [(plan, m) for plan in PLANS for m in (1, world, 2 * world + 1)]


def _mlp(mesh, world, plan, n_micro):
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.launch.steps import make_pipeline_train_step

    stage_plan = StagePlan(n_layers=MLP_LAYERS, weights=_weights(plan, world))
    return make_pipeline_train_step(mesh, stage_plan, width=MLP_WIDTH, vocab_size=MLP_VOCAB,
                                    seq_len=MLP_SEQ, global_batch=2 * n_micro,
                                    n_micro=n_micro, device="cpu", peak_lr=1e-2,
                                    warmup_steps=1, total_steps=10)


def _mlp_batch(n_micro, step=0):
    gen = torch.Generator().manual_seed(100 + step)
    return {k: torch.randint(0, MLP_VOCAB, (2 * n_micro, MLP_SEQ), generator=gen)
            for k in ("tokens", "targets")}


def _mlp_rank_cases(mesh, world):
    """{(plan, M): this rank's loss, unit gradients, units, stash peak and
    P2P messages sent in one pipelined call}."""
    from repro_torch.dist import p2p

    out = {}
    for plan, m in _mlp_cases(world):
        built = _mlp(mesh, world, plan, m)
        params = built.init_params()
        sent = p2p.COUNTS["send"]
        loss, grads = built.pipeline_call(params, _mlp_batch(m))
        out[(plan, m)] = dict(loss=loss, grads=grads["layers"], units=built.share.units,
                              peak=built.pipeline.last_stash_peak,
                              p2p_sends=p2p.COUNTS["send"] - sent)
    return out


def _gpipe_layer(w, a):
    return a + torch.tanh(a @ w)


def _gpipe_inputs(world):
    """(stage stack of 2 stages a rank, input of 3 microbatches)."""
    gen = torch.Generator().manual_seed(7)
    return (0.3 * torch.randn((2 * world, MLP_WIDTH, MLP_WIDTH), generator=gen),
            torch.randn((6, MLP_SEQ, MLP_WIDTH), generator=gen))


def _gpipe_rank_case(mesh, world, rank):
    """``gpipe_forward``'s output on every rank from this rank's stages."""
    from repro_torch.dist.pipeline import gpipe_forward

    stages, x = _gpipe_inputs(world)
    return gpipe_forward(_gpipe_layer, stages[2 * rank:2 * rank + 2], x, mesh=mesh, axis="pod",
                         n_micro=3)


def _model_cfg(arch, n_layers=None):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused",
                                         dtype="float32", seq_impl="parallel")
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def _model_step(cfg, mesh, plan):
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.optim import AdamWConfig

    return make_transformer_pipeline_train_step(
        cfg, mesh, plan, seq_len=SEQ, global_batch=BATCH, n_micro=MICRO, device="cpu",
        opt_cfg=AdamWConfig(clip_norm=CLIP), peak_lr=1e-2, warmup_steps=1, total_steps=10)


def _model_rank_case(mesh, world, arch, full, batch, ref_grads):
    """This rank's loss and gradient share, its units, its parameters and
    optimizer state after one AdamW step, from the whole tree ``full``; and
    the clip norm its share gives of the reference's gradient ``ref_grads``
    and of an all-ones tree."""
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = _model_cfg(arch)
    built = _model_step(cfg, mesh, StagePlan.equal(range(world), cfg.n_layers))
    norms = {name: built.share.clip_norm(built.share.cut(tree))
             for name, tree in (("reference", ref_grads),
                                ("ones", tree_map(torch.ones_like, full)))}
    params = built.share.cut(full)
    loss, grads = built.pipeline_call(params, batch)
    params, opt_state, metrics = built.fn(params, init_opt_state(AdamWConfig(), params), batch)
    return dict(loss=loss, grads=grads, units=built.share.units, params=params,
                opt_state=opt_state, grad_norm=metrics["grad_norm"], norms=norms)


def _restage_rank_case(mesh, world):
    """Two AdamW steps of the MLP stack on ``world`` processes, the plan
    derated between them: the units and the whole gathered state after each
    step (rank 0), and which units this rank held."""
    from repro_torch.optim import AdamWConfig, init_opt_state

    built = _mlp(mesh, world, "even", 4)
    params = built.init_params()
    opt_state = init_opt_state(AdamWConfig(), params)
    out = {"units": [], "gathered": []}
    for step in range(2):
        if step == 1:
            built.stage_plan.set_weight(0, 0.2)
        params, opt_state, _ = built.fn(params, opt_state, _mlp_batch(4, step))
        out["units"].append(built.share.units)
        out["gathered"].append(built.share.gather(params, opt_state))
    return out


def _train_settings(root, name, stages, *, steps=TRAIN["steps"], ckpt=None):
    from repro_torch.launch.train import TrainSettings

    return TrainSettings(
        arch="llama3.2-1b", smoke=True, steps=steps, global_batch=TRAIN["batch"],
        seq_len=TRAIN["seq"], seed=0, report_every=0, device="cpu",
        log_path=os.path.join(root, f"{name}.jsonl"), lr_total_steps=TRAIN["steps"],
        ckpt_dir=ckpt, ckpt_mode="fixed" if ckpt and steps < TRAIN["steps"] else "off",
        ckpt_every=1000, pipeline_stages=stages, pipeline_model=True,
        pipeline_micro=TRAIN["micro"], peak_lr=1e-2)


def _train(root, name, stages, session=None, **kw):
    from repro_torch.launch.train import run_training
    from repro_torch.timing import TimingSession

    _fresh_registries()
    return run_training(_train_settings(root, name, stages, **kw), cfg=_model_cfg(
        "llama3.2-1b", n_layers=4), session=session or TimingSession())


def _fresh_train(root, name, stages, kw):
    """``_train`` in a fresh process at one thread, as each rank runs; the
    summary's picklable parts."""
    torch.set_num_threads(1)
    summary = _train(root, name, stages, **kw)
    return {key: summary[key] for key in ("pipeline", "resume")}


def _single_controller(root, *runs):
    """The single controller's launcher runs ``(name, kw)`` on 4 stages, one
    after another in one fresh process: the losses the ranks' runs are held
    to bit for bit come from a process that, like each rank, inherits
    nothing of this test process (its thread count, its process-global
    state)."""
    with ProcessPoolExecutor(max_workers=1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return [pool.submit(_fresh_train, root, name, 4, kw).result() for name, kw in runs]


def _losses(path):
    with open(path) as fh:
        return [json.loads(line)["extra"]["loss"] for line in fh if line.strip()]


class _Restager:
    """Derates stage 0 on rank 0's control loop at poll ``RESTAGE_AT``."""

    name = "restager"
    channels = ()

    def __init__(self, loop):
        self.loop = loop

    def control(self, step, measurements):
        if step == RESTAGE_AT:
            self.loop.controller("stragglers").stage_plan.set_weight(0, 0.2)
        return []


def _launcher_rank_cases(rank, world, root):
    """The launcher on ``world`` processes: a restore of the single
    controller's save, a save at label ``TRAIN["at"]`` (4 processes), or
    (2 processes) an uninterrupted run, a restore of the 4-process save, a
    restage decided on rank 0, and the world-size check."""
    import torch.distributed as dist

    from repro_torch.dist.pipeline import PipelineStep
    from repro_torch.timing import TimingSession

    out = {}
    if world == 4:
        _train(root, "resumed_on4", 4, ckpt=os.path.join(root, "single_on4"))
        summary = _train(root, "saved4", 4, steps=TRAIN["at"], ckpt=os.path.join(root, "ck4"))
        out["pipeline"] = summary["pipeline"]
        return out
    out["pipeline"] = _train(root, "procs2", 2)["pipeline"]
    dist.barrier()
    if rank == 0:
        shutil.copytree(os.path.join(root, "ck4"), os.path.join(root, "ck4_on2"))
    dist.barrier()
    _train(root, "ck4_on2", 2, ckpt=os.path.join(root, "ck4_on2"))
    # a restage decided on rank 0: every rank's pipeline calls, by step
    slots = []
    call = PipelineStep.__call__

    def spy(self, stage_params, *args, **kwargs):
        from repro_torch.models.layers import tree_leaves

        slots.append(int(tree_leaves(stage_params)[0].shape[0]))
        return call(self, stage_params, *args, **kwargs)

    PipelineStep.__call__ = spy
    try:
        sess = TimingSession()
        if rank == 0:
            sess.control_loop.register(_Restager(sess.control_loop))
        summary = _train(root, "restaged", 2, session=sess)
    finally:
        PipelineStep.__call__ = call
    out["restage"] = dict(slots=slots, depths=summary["pipeline"]["depths"])
    try:
        _train(root, "wrong_world", 3)
    except ValueError as exc:
        out["world_error"] = str(exc)
    return out


def _worker(rank, world, root, model_cases):
    from repro_torch.dist.meshutil import device_mesh

    torch.set_num_threads(1)
    mesh = device_mesh((world,), ("pod",), "cpu")
    out = {"mlp": _mlp_rank_cases(mesh, world), "gpipe": _gpipe_rank_case(mesh, world, rank)}
    if world == 2:
        out["models"] = {arch: _model_rank_case(mesh, world, arch, *case)
                         for arch, case in model_cases.items()}
        out["restage"] = _restage_rank_case(mesh, world)
    out["launcher"] = _launcher_rank_cases(rank, world, root)
    return out


# ---------------------------------------------------------------------------
# single-controller references (this process) and the spawns
# ---------------------------------------------------------------------------

def _jax_case(arch):
    """The reference config, params as JAX and torch trees, a batch with
    every target valid (the pipelined loss is the mean of the
    microbatches'), and the reference's loss and gradient from
    ``jax.value_and_grad`` of its ``loss_fn`` (the gradient also as a torch
    tree in the port's key order)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import model as JM
    from repro_torch.bridge import to_torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map

    cfg = _model_cfg(arch)
    cfg_j = jax_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused",
                                           dtype="float32")
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens, targets = (rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
                       for _ in range(2))
    # the port's key order (JAX sorts a dict's keys): the optimizer walks
    # the params and their gradient leaf by leaf
    port_order = lambda tree: tree_map(  # noqa: E731
        lambda _, leaf: leaf, M.abstract_params(cfg), to_torch(jax.tree.map(np.asarray, tree)))
    batch_j = {"tokens": jax.numpy.asarray(tokens), "targets": jax.numpy.asarray(targets)}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j)[0])(params_j)
    return dict(cfg_j=cfg_j, params_j=params_j, params=port_order(params_j),
                batch={"tokens": torch.from_numpy(tokens),
                       "targets": torch.from_numpy(targets)},
                ref_loss=float(ref_loss), ref_grads_j=ref_grads,
                ref_grads=port_order(ref_grads))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The single controller's launcher runs: uninterrupted, and saved at
    label ``TRAIN["at"]`` (a copy for the 4 processes to restore)."""
    path = str(tmp_path_factory.mktemp("pipeline_procs"))
    _single_controller(path, ("single", {}), ("single_saved", dict(
        steps=TRAIN["at"], ckpt=os.path.join(path, "single_on4"))))
    return path


@pytest.fixture(scope="module")
def jax_cases():
    return {arch: _jax_case(arch) for arch in ("llama3.2-1b", "rwkv6-1.6b")}


@pytest.fixture(scope="module")
def procs4(root):
    return run_ranks(_worker, 4, root, {})


@pytest.fixture(scope="module")
def procs2(root, procs4, jax_cases):
    cases = {arch: (case["params"], case["batch"], case["ref_grads"])
             for arch, case in jax_cases.items()}
    return run_ranks(_worker, 2, root, cases)


def _procs(request, world):
    return request.getfixturevalue(f"procs{world}")


def _single_mlp(world, plan, n_micro):
    from repro_torch.dist.meshutil import local_mesh

    built = _mlp(local_mesh((world,), ("pod",), device="cpu"), world, plan, n_micro)
    params = built.init_params()
    return built, params, built.pipeline_call(params, _mlp_batch(n_micro))


def _whole(cfg, ranks, key):
    """The whole params-shaped tree of the ranks' ``key`` shares: the unit
    stack's rows in rank order, every other piece from the first rank that
    holds it."""
    from repro_torch.models.layers import tree_leaves, tree_map

    from repro_torch.models import model as M

    shares = [r[key] for r in ranks]
    out = {}
    for name in M.abstract_params(cfg):
        if name == "scan":
            stacks = [tree_leaves(s["scan"]) for s in shares]
            it = iter([torch.cat(parts) for parts in zip(*stacks)])
            out[name] = tree_map(lambda _: next(it), shares[0]["scan"])
        else:
            out[name] = next(s[name] for s in shares if name in s)
    return out


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,plan,n_micro",
                         [(w, p, m) for w in (2, 4) for p, m in _mlp_cases(w)])
def test_mlp_processes_match_the_single_controller_bit_for_bit(request, world, plan, n_micro):
    from repro_torch.dist.pipeline import StagePlan

    ranks = _procs(request, world)
    built, _, (loss, grads) = _single_mlp(world, plan, n_micro)
    units = [r["mlp"][(plan, n_micro)]["units"] for r in ranks]
    assert units == list(StagePlan(n_layers=MLP_LAYERS,
                                   weights=_weights(plan, world)).boundaries().values())
    for rank, r in enumerate(ranks):
        got = r["mlp"][(plan, n_micro)]
        a, b = got["units"]
        assert torch.equal(got["loss"], loss), (rank, got["loss"], loss)
        assert torch.equal(got["grads"], grads["layers"][a:b]), rank


@pytest.mark.parametrize("world", [2, 4])
def test_gpipe_forward_on_processes_matches_the_single_controller(request, world):
    from repro_torch.dist.meshutil import local_mesh
    from repro_torch.dist.pipeline import gpipe_forward

    stages, x = _gpipe_inputs(world)
    want = gpipe_forward(_gpipe_layer, stages, x, mesh=local_mesh((world,), ("pod",),
                                                                  device="cpu"),
                         axis="pod", n_micro=3)
    for r in _procs(request, world):
        assert torch.equal(r["gpipe"], want)


@pytest.mark.parametrize("world,plan,n_micro",
                         [(w, p, m) for w in (2, 4) for p, m in _mlp_cases(w)])
def test_stash_and_ring_messages_per_step(request, world, plan, n_micro):
    ranks = _procs(request, world)
    got = [r["mlp"][(plan, n_micro)] for r in ranks]
    assert max(g["peak"] for g in got) <= min(2 * world, n_micro)
    # the transport's count: the MLP stack has no tied table, so every
    # message of the call is a ring's
    assert sum(g["p2p_sends"] for g in got) == 2 * (world - 1) * n_micro
    # the end ranks send on one ring, the middle ranks on both
    assert [g["p2p_sends"] for g in got] == [
        n_micro * ((d > 0) + (d < world - 1)) for d in range(world)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_transformer_processes_match_the_single_controller_and_jax(procs2, jax_cases, arch):
    import jax

    from repro_torch.dist.meshutil import local_mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.models.layers import tree_leaves, tree_map

    case = jax_cases[arch]
    params, batch = case["params"], case["batch"]
    cfg = _model_cfg(arch)
    built = _model_step(cfg, local_mesh((2,), ("pod",), device="cpu"),
                        StagePlan.equal(range(2), cfg.n_layers))
    loss, grads = built.pipeline_call(params, batch)
    ranks = [r["models"][arch] for r in procs2]
    for r in ranks:
        assert torch.equal(r["loss"], loss), (r["loss"], loss)
    got = _whole(cfg, ranks, "grads")
    assert list(got) == list(grads)
    flat, ref = tree_leaves(got), tree_leaves(grads)
    assert len(flat) == len(ref) and all(torch.equal(a, b) for a, b in zip(flat, ref))
    assert abs(float(loss) - case["ref_loss"]) < 2e-4
    worst = []  # leaves matched by their path: tree_map walks the reference by key
    tree_map(lambda a, b: worst.append(float(np.max(np.abs(a.numpy() - np.asarray(b))))),
             got, jax.tree.map(np.asarray, case["ref_grads_j"]))
    assert len(worst) == len(flat) and max(worst) < 2e-4, max(worst)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_one_adamw_step_matches_the_single_controller(procs2, jax_cases, arch):
    from repro_torch.dist.meshutil import local_mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state

    params, batch = jax_cases[arch]["params"], jax_cases[arch]["batch"]
    cfg = _model_cfg(arch)
    built = _model_step(cfg, local_mesh((2,), ("pod",), device="cpu"),
                        StagePlan.equal(range(2), cfg.n_layers))
    new, state, metrics = built.fn(params, init_opt_state(AdamWConfig(), params), batch)
    ranks = [r["models"][arch] for r in procs2]
    for r in ranks:
        assert torch.equal(r["grad_norm"], metrics["grad_norm"])
    got = _whole(cfg, ranks, "params")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(new)))
    for key in ("m", "v", "master"):
        whole = _whole(cfg, [{"s": r["opt_state"][key]} for r in ranks], "s")
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(whole), tree_leaves(state[key]))), key
    first, last = (r["params"] for r in ranks)
    assert ("embed" in last) == cfg.tied_embeddings and ("lm_head" in last) != \
        cfg.tied_embeddings
    if cfg.tied_embeddings:  # the two copies of the tied table stay identical
        assert torch.equal(first["embed"]["tokens"], last["embed"]["tokens"])
        assert torch.equal(ranks[0]["opt_state"]["master"]["embed"]["tokens"],
                           ranks[1]["opt_state"]["master"]["embed"]["tokens"])
    assert "final_norm" not in first and "embed" in first


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_clip_norm_is_the_references_global_norm(procs2, jax_cases, arch):
    """Both modes' clip norm (``clip_norm`` on the single controller,
    ``RankShare.clip_norm`` from each process's share) against the
    reference's ``global_norm``: of the reference's own gradient within
    1e-6 relative (the two add the same f32 squares in different orders),
    and of an all-ones tree bit for bit (each sum is an integer below 2^24,
    exact in either order), so every element counts once: no leaf
    dropped, the tied table (llama) not counted twice."""
    import jax

    from repro.optim.adamw import global_norm
    from repro_torch.dist.pipeline_state import clip_norm
    from repro_torch.models.layers import tree_leaves, tree_map

    case = jax_cases[arch]
    assert _model_cfg(arch).tied_embeddings == (arch == "llama3.2-1b")
    norms = [r["models"][arch]["norms"] for r in procs2]
    want = float(global_norm(case["ref_grads_j"]))
    got = [float(clip_norm(case["ref_grads"], "scan"))] + [float(n["reference"]) for n in norms]
    assert all(abs(g - want) <= 1e-6 * want for g in got), (got, want)
    assert want > CLIP  # the clip is active at this gradient
    ones = tree_map(torch.ones_like, case["params"])
    count = sum(leaf.numel() for leaf in tree_leaves(ones))
    want_ones = global_norm(jax.tree.map(jax.numpy.ones_like, case["params_j"]))
    assert count < 2 ** 24 and float(want_ones) == float(np.sqrt(np.float32(count)))
    got_ones = [clip_norm(ones, "scan")] + [n["ones"] for n in norms]
    assert all(float(g) == float(want_ones) for g in got_ones), (got_ones, want_ones)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_one_adamw_step_matches_the_references_adamw_update(procs2, jax_cases, arch):
    """The processes' optimizer state after one step against the
    reference's ``adamw_update`` of the same gradient (the processes',
    gathered): ``m`` and ``v`` carry the clip scale, so a wrong norm shows
    there; within 1e-5 relative, the norms' own rounding."""
    import jax

    from repro.optim import AdamWConfig, adamw_update, init_opt_state
    from repro.optim.schedules import warmup_cosine
    from repro_torch.models.layers import tree_map

    case = jax_cases[arch]
    cfg = _model_cfg(arch)
    ranks = [r["models"][arch] for r in procs2]
    grads = tree_map(lambda leaf: jax.numpy.asarray(leaf.numpy()), _whole(cfg, ranks, "grads"))
    params_j = case["params_j"]
    lr = warmup_cosine(0, peak_lr=1e-2, warmup_steps=1, total_steps=10)
    opt_cfg = AdamWConfig(clip_norm=CLIP)
    _, state_j, stats = adamw_update(opt_cfg, params_j, grads, init_opt_state(opt_cfg, params_j),
                                     lr)
    assert float(stats["clip_scale"]) < 1.0  # the clip is active
    assert abs(float(ranks[0]["grad_norm"]) - float(stats["grad_norm"])) <= \
        1e-6 * float(stats["grad_norm"])
    for key in ("m", "v", "master"):
        whole = _whole(cfg, [{"s": r["opt_state"][key]} for r in ranks], "s")
        worst = []
        tree_map(lambda a, b: worst.append(float(np.max(
            np.abs(a.numpy() - np.asarray(b)) / (np.abs(np.asarray(b)) + 1e-30)))),
            whole, jax.tree.map(np.asarray, state_j[key]))
        assert worst and max(worst) <= 1e-5, (key, max(worst))


def test_restage_moves_units_with_their_optimizer_state(procs2):
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state

    built, params, _ = _single_mlp(2, "even", 4)
    opt_state = init_opt_state(AdamWConfig(), params)
    ref = []
    for step in range(2):
        if step == 1:
            built.stage_plan.set_weight(0, 0.2)
        params, opt_state, _ = built.fn(params, opt_state, _mlp_batch(4, step))
        # the optimizer updates its state in place: keep copies
        ref.append([leaf.clone() for leaf in tree_leaves(params) + tree_leaves(opt_state)])
    units = [r["restage"]["units"] for r in procs2]
    derated = StagePlan(n_layers=MLP_LAYERS, weights={0: 0.2, 1: 1.0}).boundaries()
    assert derated == {0: (0, 2), 1: (2, 8)}
    assert units == [[(0, 4), derated[0]], [(4, 8), derated[1]]]
    assert all(r["restage"]["gathered"][step] == (None, None)
               for r in procs2[1:] for step in range(2))
    for step in range(2):
        params_g, state_g = procs2[0]["restage"]["gathered"][step]
        assert list(state_g) == ["step", "m", "v", "master"]
        got = tree_leaves(params_g) + tree_leaves(state_g)
        assert len(got) == len(ref[step]) and all(
            torch.equal(a, b) for a, b in zip(got, ref[step])), step


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_run_training_on_two_processes_gives_the_single_controllers_losses(root, procs2):
    want = _losses(os.path.join(root, "single.jsonl"))
    assert len(want) == TRAIN["steps"]
    assert _losses(os.path.join(root, "procs2.jsonl")) == want
    assert not os.path.exists(os.path.join(root, "rank1.jsonl"))
    pipe = procs2[0]["launcher"]["pipeline"]
    assert pipe["mode"] == "processes" and pipe["backend"] == "gloo" and pipe["rank"] == 0
    assert len(pipe["rank_phase_seconds"]) == 2
    assert all(s > 0 for ranks in pipe["rank_phase_seconds"] for s in ranks.values())
    # per step: M ring messages from each end rank, and the tied table's swap
    per_step = TRAIN["micro"] + 1
    assert pipe["p2p_calls"] == {"send": TRAIN["steps"] * per_step,
                                 "recv": TRAIN["steps"] * per_step}
    assert pipe["p2p_bytes"]["send"] > 0 and pipe["p2p_seconds"]["recv"] > 0
    assert procs2[1]["launcher"]["pipeline"]["rank"] == 1


@pytest.mark.parametrize("run,world", [("resumed_on4", 4), ("ck4_on2", 2), ("single_on", 1)])
def test_saves_restore_across_process_counts(root, procs2, run, world):
    """The single controller's save resumes on 4 processes; the 4
    processes' save on 2 processes and on the single controller."""
    want = _losses(os.path.join(root, "single.jsonl"))
    at = TRAIN["at"]
    if run == "single_on":
        shutil.copytree(os.path.join(root, "ck4"), os.path.join(root, "ck4_on1"))
        summary, = _single_controller(root, ("ck4_on1", dict(ckpt=os.path.join(root,
                                                                              "ck4_on1"))))
        assert summary["resume"]["selected_step"] == at
        assert summary["pipeline"]["mode"] == "controller"
        run = "ck4_on1"
    assert _losses(os.path.join(root, "saved4.jsonl")) == want[:at]
    assert _losses(os.path.join(root, f"{run}.jsonl")) == want[at:]
    assert sorted(os.listdir(os.path.join(root, "ck4"))) == [f"step_{at:08d}"]


def test_restage_decided_on_rank0_runs_on_every_rank_at_the_same_step(procs2):
    from repro_torch.dist.pipeline import StagePlan

    slots = [r["launcher"]["restage"]["slots"] for r in procs2]
    equal = StagePlan.equal(range(2), 4).depths()
    derated = StagePlan(n_layers=4, weights={0: 0.2, 1: 1.0}).depths()
    assert equal != derated
    for rank, got in enumerate(slots):
        assert len(got) == TRAIN["steps"]
        cut = RESTAGE_AT + 1  # decided at step RESTAGE_AT's poll, run from the next step
        assert got == [equal[rank]] * cut + [derated[rank]] * (TRAIN["steps"] - cut), rank
    assert all(r["launcher"]["restage"]["depths"] == derated for r in procs2)


def test_pipeline_stages_other_than_the_world_raise(procs2):
    assert "pipeline_stages=3 but the process group has 2 ranks" in \
        procs2[0]["launcher"]["world_error"]


def test_run_training_in_one_process_stays_the_single_controller(root):
    summary = _train(root, "one_process", 2, steps=1)
    assert summary["pipeline"]["mode"] == "controller"
    assert "p2p_calls" not in summary["pipeline"]
