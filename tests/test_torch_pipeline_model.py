"""PyTorch port, the real model through the 1F1B pipeline
(``repro_torch.models.pipeline``): loss and every gradient leaf against
``jax.value_and_grad`` of the reference's non-pipelined ``loss_fn`` (the
reference's own criterion, ``src/repro/models/pipeline.py:13-15``; its 1F1B
with the transformer raises ``ShardingTypeError`` under this container's
jax) at 2e-4, and against the port's own ``loss_fn`` at 1e-5, in f32 at seq
128 with the port's kernel selections (``attn_impl="pallas"``,
``norm_impl="fused"``: their plain versions on CPU tensors; the reference
runs its kernels in interpret mode).  Also a restaged plan on 4 CPU ranks,
``check_pipelineable``'s rejections, the split/merge round trip, and the
kernel launches per pipelined step that ``chip_smoke.py`` phase 26 asserts.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.config import ArchConfig as JaxArchConfig
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.dist.meshutil import local_mesh
from repro_torch.dist.pipeline import PipelineStep, StagePlan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import model as PM, pipeline as MP
from repro_torch.models.config import ArchConfig, MoESettings
from repro_torch.models.layers import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SEQ, BATCH = 128, 4

_BASE = dict(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=96,
    dtype="float32", norm_impl="fused", remat="none",
)


def _dense(**kw):
    return dict(name="pipe-dense", family="dense", attn_impl="pallas",
                **{**_BASE, "tied_embeddings": True, **kw})


def _hybrid(**kw):
    return dict(name="pipe-hybrid", family="hybrid", attn_impl="pallas",
                block_pattern=("rglru", "attn_local", "attn_local"), window=64,
                tied_embeddings=True, **{**_BASE, **{"n_layers": 6, **kw}})


def _rwkv(**kw):
    return dict(name="pipe-rwkv", family="ssm", block_pattern=("rwkv",),
                rwkv_head_dim=16, n_kv_heads=4, tied_embeddings=False,
                **{**{k: v for k, v in _BASE.items() if k != "n_kv_heads"}, **kw})


def _configs(fields):
    """(reference config, port config): the port trains the recurrences
    through their PyTorch forms (``seq_impl="parallel"``), as the
    reference's blocks train through their jnp forms."""
    return JaxArchConfig(**fields), ArchConfig(**fields, seq_impl="parallel")


def _setup(cfg_j, batch=BATCH):
    params_j = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (batch, SEQ)).astype(np.int32)
    targets = rng.integers(0, cfg_j.vocab_size, (batch, SEQ)).astype(np.int32)
    return params_j, tokens, targets


def _pipeline(cfg, params, tokens, targets, *, n_micro, plan, n_ranks=1):
    layer_fn, first_fn, last_fn = MP.make_stage_fns(cfg)
    step = PipelineStep(layer_fn, None, mesh=local_mesh((n_ranks,), ("pod",), device="cpu"),
                        axis="pod", n_micro=n_micro, first_fn=first_fn, last_fn=last_fn)
    stack, first, last = MP.split_params(cfg, params)
    packed, mask = plan.pack(stack)
    loss, (pg, fg, lg) = step(packed, torch.from_numpy(tokens), torch.from_numpy(targets),
                              stage_mask=mask, first_params=first, last_params=last)
    return loss, MP.merge_grads(cfg, plan.unpack(pg), fg, lg)


def _port_reference(cfg, params, tokens, targets):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = PM.loss_fn(cfg, live, {"tokens": torch.from_numpy(tokens),
                                     "targets": torch.from_numpy(targets)})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _hold(loss, grads, ref_loss, ref_grads, tol):
    """Loss and every leaf elementwise within ``tol``; leaves are matched by
    their path (``tree_map`` walks the reference tree by key)."""
    loss, ref_loss = float(loss.detach()), float(ref_loss)
    assert abs(loss - ref_loss) < tol, (loss, ref_loss)
    worst = []

    def one(got, ref):
        ref = np.asarray(ref, np.float32)
        assert tuple(got.shape) == ref.shape
        worst.append(float(np.max(np.abs(got.detach().float().numpy() - ref))))

    tree_map(one, grads, ref_grads)
    assert worst and max(worst) < tol, max(worst)


@pytest.mark.parametrize("fields,n_micro,plan_weights", [
    (_dense(), 2, None),
    (_dense(), 4, {0: 1.0, 1: 3.0}),
    (_hybrid(), 2, None),
    (_rwkv(), 2, None),
], ids=["dense", "dense-uneven-2-ranks", "hybrid", "rwkv"])
def test_pipeline_matches_reference_and_port_loss(fields, n_micro, plan_weights):
    cfg_j, cfg = _configs(fields)
    n_units = MP.check_pipelineable(cfg)
    params_j, tokens, targets = _setup(cfg_j)
    batch_j = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    ref_loss, ref_grads = jax.value_and_grad(lambda p: JM.loss_fn(cfg_j, p, batch_j)[0])(params_j)
    params = to_torch(jax.tree.map(np.asarray, params_j))
    if plan_weights is None:
        plan, n_ranks = StagePlan.equal(range(1), n_units), 1
    else:
        plan, n_ranks = StagePlan(n_layers=n_units, weights=plan_weights), len(plan_weights)
    loss, grads = _pipeline(cfg, params, tokens, targets, n_micro=n_micro, plan=plan,
                            n_ranks=n_ranks)
    _hold(loss, grads, ref_loss, jax.tree.map(np.asarray, ref_grads), 2e-4)
    own_loss, own_grads = _port_reference(cfg, params, tokens, targets)
    _hold(loss, grads, own_loss, tree_map(lambda g: g.numpy(), own_grads), 1e-5)


def test_restaged_plan_on_four_cpu_ranks():
    """8 units on 4 ranks, equal then restaged (a slow stage's weight
    derated): both match the non-pipelined reference, and the restaged call
    gives the same bits, since the same layers run in the same order and
    padded slots run nothing."""
    cfg_j, cfg = _configs(_dense(n_layers=8, tied_embeddings=False))
    params_j, tokens, targets = _setup(cfg_j, batch=8)
    batch_j = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    ref_loss, ref_grads = jax.value_and_grad(lambda p: JM.loss_fn(cfg_j, p, batch_j)[0])(params_j)
    params = to_torch(jax.tree.map(np.asarray, params_j))
    plan = StagePlan.equal(range(4), 8)
    equal = _pipeline(cfg, params, tokens, targets, n_micro=8, plan=plan, n_ranks=4)
    plan.set_weight(1, 0.1)
    assert plan.depths() == {0: 3, 1: 1, 2: 2, 3: 2} and plan.max_depth() == 3
    restaged = _pipeline(cfg, params, tokens, targets, n_micro=8, plan=plan, n_ranks=4)
    _hold(*equal, ref_loss, jax.tree.map(np.asarray, ref_grads), 2e-4)
    assert torch.equal(equal[0], restaged[0])
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(equal[1]), tree_leaves(restaged[1])))


def test_check_pipelineable_rejections():
    _, dense = _configs(_dense())
    _, hybrid = _configs(_hybrid())
    with pytest.raises(ValueError, match="family 'vlm' is not pipelineable"):
        MP.check_pipelineable(dense.replace(family="vlm"))
    with pytest.raises(ValueError, match="family 'encdec' is not pipelineable"):
        MP.check_pipelineable(dense.replace(family="encdec"))
    with pytest.raises(ValueError, match="MoE configs are not pipelineable"):
        MP.check_pipelineable(dense.replace(
            family="moe", moe=MoESettings(n_experts=4, top_k=2, d_expert=64)))
    with pytest.raises(ValueError, match="n_layers=7 not divisible by pattern"):
        MP.check_pipelineable(hybrid.replace(n_layers=7))
    assert MP.check_pipelineable(hybrid) == 2
    assert MP.check_pipelineable(get_config("llama3.2-1b")) == 16
    for arch in ("moonshot-v1-16b-a3b", "internvl2-26b", "seamless-m4t-large-v2"):
        with pytest.raises(ValueError, match="not pipelineable"):
            MP.check_pipelineable(get_config(arch))


@pytest.mark.parametrize("tied", [True, False])
def test_split_merge_round_trip(tied):
    _, cfg = _configs(_dense(tied_embeddings=tied))
    params = PM.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    stack, first, last = MP.split_params(cfg, params)
    assert stack is params["scan"] and first["embed"] is params["embed"]
    assert ("embed" in last) == tied and ("lm_head" in last) == (not tied)
    if tied:  # the head's half of the table's gradient zero: merge gives the first's
        last = {**last, "embed": tree_map(torch.zeros_like, last["embed"])}
    merged = MP.merge_grads(cfg, stack, first, last)
    assert list(merged) == list(params)
    flat, ref = tree_leaves(merged), tree_leaves(params)
    assert len(flat) == len(ref) and all(torch.equal(a, b) for a, b in zip(flat, ref))
    if tied:  # the gather half and the head half of the table's gradient add
        summed = MP.merge_grads(cfg, stack, first, {**last, "embed": first["embed"]})
        assert torch.equal(summed["embed"]["tokens"], 2 * params["embed"]["tokens"])


@pytest.mark.parametrize("n_ranks,n_micro", [(1, 2), (2, 4)])
def test_launches_per_pipelined_step(monkeypatch, n_ranks, n_micro):
    """The plain versions stand in for the kernels on the CPU, so counting
    their calls gives the launches of the card's run: each unit's forward
    runs at its forward tick and again in the backward's recompute, the
    final norm once a microbatch, with its backward; padded slots run
    nothing, so a restaged plan launches as many.  ``chip_smoke``'s
    ``_pipeline_launches`` gives the same, and phase 26's counts at full
    depth (L = 16, M = 4) are 128 / 64 / 64 / 260 / 132."""
    calls = dict.fromkeys(("flash_fwd", "flash_bwd", "rms", "rms_bwd"), 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, attr, name in ((fa_ops, "flash_fwd_plain", "flash_fwd"),
                            (fa_ops, "flash_bwd_plain", "flash_bwd"),
                            (rn_ops, "rms_norm_plain", "rms"),
                            (rn_ops, "rms_norm_bwd_plain", "rms_bwd")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    cfg_j, cfg = _configs(_dense(n_layers=4))
    params_j, tokens, targets = _setup(cfg_j)
    params = to_torch(jax.tree.map(np.asarray, params_j))
    want = chip_smoke._pipeline_launches(cfg, n_micro)
    for weights in ({r: 1.0 for r in range(n_ranks)}, {r: 1.0 + r for r in range(n_ranks)}):
        calls.update(dict.fromkeys(calls, 0))
        plan = StagePlan(n_layers=4, weights=weights)
        _pipeline(cfg, params, tokens, targets, n_micro=n_micro, plan=plan, n_ranks=n_ranks)
        assert {"flash_fwd": calls["flash_fwd"], "flash_bwd_dq": calls["flash_bwd"],
                "flash_bwd_dkv": calls["flash_bwd"], "rmsnorm_fwd": calls["rms"],
                "rmsnorm_bwd": calls["rms_bwd"], "rglru_fwd": 0, "wkv6_fwd": 0} == want
    assert want["flash_fwd"] == 2 * 4 * n_micro and want["rmsnorm_fwd"] == 4 * 4 * n_micro + n_micro
    full = chip_smoke._train_cfg("llama3.2-1b")
    assert chip_smoke._pipeline_launches(full, chip_smoke.PIPE_MICRO) == chip_smoke.PIPE_PER_STEP
    assert chip_smoke.PIPE_PER_STEP == {"flash_fwd": 128, "flash_bwd_dq": 64,
                                        "flash_bwd_dkv": 64, "rmsnorm_fwd": 260,
                                        "rmsnorm_bwd": 132, "rglru_fwd": 0, "wkv6_fwd": 0}
