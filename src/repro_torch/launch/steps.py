"""Step builders of the port: the training step, sharded over a DeviceMesh
or not, and the 1F1B pipeline training steps.

The reference builds jitted, sharded steps with abstract inputs for AOT
compilation; PyTorch runs eagerly, so the port's :class:`BuiltStep` holds a
plain callable and the tokens it consumes per call.  Sharding follows the
reference's logical axes: :func:`rules_for` picks a config's rule table,
:func:`batch_axes` and ``models.model.param_axes`` annotate the inputs, and
:func:`shardings_for` resolves them on a mesh.  A training step built with a
``DeviceMesh`` distributes nothing itself: the launcher hands it DTensor
params, optimizer state and batch laid out as those specs say, and the step
runs the loss under the sharding context (``dist.context.use_sharding``), so
the model's ``constrain`` calls and its kernel boundaries apply.  The
prefill and serve step builders come with a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from ..dist.context import is_dtensor, use_sharding
from ..dist.meshutil import Mesh
from ..dist.pipeline import PipelineStep, StagePlan
from ..dist.sharding import DEFAULT_RULES, FSDP_RULES, ShardingRules, tree_shardings
from ..models import model as M, pipeline as MP
from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_update, warmup_cosine
from ..timing import timed

__all__ = [
    "rules_for",
    "batch_axes",
    "shardings_for",
    "BuiltStep",
    "PipelineBuiltStep",
    "make_train_step",
    "make_pipeline_train_step",
    "make_transformer_pipeline_train_step",
]


def rules_for(cfg: ArchConfig, overrides: dict[str, Any] | None = None) -> ShardingRules:
    """The config's rule table: ``FSDP_RULES`` under ``cfg.sharding ==
    "tp+fsdp"``, else ``DEFAULT_RULES``; ``overrides`` replace entries."""
    rules = FSDP_RULES if cfg.sharding == "tp+fsdp" else DEFAULT_RULES
    if overrides:
        rules = rules.with_overrides(**overrides)
    return rules


def batch_axes(cfg: ArchConfig, kind: str) -> dict[str, tuple]:
    """Logical axes of each batch input."""
    axes: dict[str, tuple] = {}
    if kind in ("train",):
        axes["tokens"] = ("batch", "seq")
        axes["targets"] = ("batch", "seq")
    elif kind == "prefill":
        axes["tokens"] = ("batch", "seq")
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        axes["patch_embeds"] = ("batch", None, None)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        axes["src_frames"] = ("batch", "seq", None)
    return axes


def shardings_for(axes_tree_, shape_tree, mesh, rules: ShardingRules):
    """``PartitionSpec`` of every leaf of an axes tree against a matching tree
    of shapes (``dist.sharding.tree_shardings``)."""
    return tree_shardings(axes_tree_, shape_tree, mesh, rules)


@dataclass
class BuiltStep:
    #: ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    fn: Callable[..., Any]
    #: tokens consumed per invocation — launchers feed this into the "tokens"
    #: counter channel (one counter_cell bump per executed step)
    tokens_per_call: int = 0


def _grads(cfg: ArchConfig, params, batch):
    """(grads in the params' dtypes, metrics) of ``M.loss_fn``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, metrics = M.loss_fn(cfg, live, batch)
    # a leaf the loss does not reach raises here rather than training on zeros
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return tree_map(lambda _: next(it), params), {k: v.detach() for k, v in metrics.items()}


# scope-aware decorator: nests under the caller's active scope (the
# STARTUP driver routine in launchers)
@timed("steps::make_train_step")
def make_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig,
    opt_cfg: AdamWConfig | None = None,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    accum_steps: int = 1,
    mesh: Any = None,
    rules: ShardingRules | None = None,
) -> BuiltStep:
    """``accum_steps > 1``: microbatched gradient accumulation — the global
    batch is split into microbatches run one after another and their f32
    gradients averaged; activation memory scales down by the factor while
    FLOPs per token are unchanged.  The learning rate is ``warmup_cosine`` of
    the optimizer state's ``step``.

    ``mesh``: a ``DeviceMesh`` of more than one rank makes this a sharded
    step over DTensor params, state and batch (the module docstring), run
    under ``use_sharding(mesh, rules)`` (``rules`` defaults to
    :func:`rules_for`); each gradient is reduced to its parameter's
    placements before the update, and the metrics come back as plain
    tensors, the same on every rank.  Without one the step is the
    unsharded step, unchanged."""
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig()
    if accum_steps < 1 or shape.global_batch % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the global batch "
                         f"{shape.global_batch}")
    sharded = mesh is not None and getattr(mesh, "mesh_dim_names", None) is not None \
        and mesh.size() > 1
    rules = rules if rules is not None else rules_for(cfg)

    def grads_of(params, batch):
        g, m = _grads(cfg, params, batch)
        if sharded:  # a Partial sum over the batch shards is reduced here
            g = tree_map(lambda gg, p: gg.redistribute(p.device_mesh, p.placements), g, params)
        return g, m

    def step(params, opt_state, batch):
        lr = warmup_cosine(
            opt_state["step"], peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
        if accum_steps > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            per_micro = []
            for micro in range(accum_steps):
                mb = {k: v.chunk(accum_steps, dim=0)[micro] for k, v in batch.items()}
                g, m = grads_of(params, mb)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.float() / accum_steps)
                per_micro.append(m)
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]}
        else:
            grads, metrics = grads_of(params, batch)
        params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state, lr)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["lr"] = lr
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        if not sharded:
            return step(params, opt_state, batch)
        with use_sharding(mesh, rules):
            params, opt_state, metrics = step(params, opt_state, batch)
        plain = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return params, opt_state, plain

    return BuiltStep(fn=train_step, tokens_per_call=shape.global_batch * shape.seq_len)


@dataclass
class PipelineBuiltStep(BuiltStep):
    """A :class:`BuiltStep` whose ``fn`` drives the 1F1B pipeline schedule.

    ``fn`` re-packs stage parameters from the live :class:`StagePlan` every
    step — that is what makes a run-time ``restage`` take effect on the very
    next step — and, when phase timing is on, runs warmup/steady/cooldown as
    separately synchronized segments.  ``init_params(generator=None)``
    draws the model's parameters on the step's device;
    ``pipeline_call(params, batch) -> (loss, grads)`` is the step without
    the optimizer.
    """

    stage_plan: StagePlan | None = None
    pipeline: PipelineStep | None = None
    init_params: Callable[..., Any] | None = None
    pipeline_call: Callable[..., Any] | None = None


def _pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps):
    """``fn(params, opt_state, batch)``: ``pipeline_call(params, batch) ->
    (loss, grads)``, then AdamW at ``warmup_cosine`` of the state's step."""

    def train_fn(params, opt_state, batch):
        loss, grads = pipeline_call(params, batch)
        lr = warmup_cosine(
            opt_state["step"], peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
        params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state, lr)
        metrics = {"loss": loss, "lr": lr}
        metrics.update(stats)
        return params, opt_state, metrics

    return train_fn


@timed("steps::make_pipeline_train_step")
def make_pipeline_train_step(
    mesh: Mesh,
    stage_plan: StagePlan,
    *,
    axis: str = "pod",
    width: int = 32,
    vocab_size: int,
    seq_len: int,
    global_batch: int,
    n_micro: int,
    opt_cfg: AdamWConfig | None = None,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    seed: int = 0,
    phase_cb: Any = None,
    device: str | torch.device = "cuda",
) -> PipelineBuiltStep:
    """Build the pipeline-parallel (1F1B) train step over mesh axis ``axis``.

    The model is a stack of ``stage_plan.n_layers`` homogeneous residual-MLP
    layers trained to map a token's (fixed, untrained) embedding to its
    next-token embedding — the homogeneous-stage workload the 1F1B schedule
    pipelines over the ``pod`` axis.  Layers are re-packed from the live
    ``stage_plan`` every step, so a straggler-triggered ``restage`` moves the
    stage boundaries for the next step without rebuilding anything.  Params,
    optimizer state and batches live on ``device``.

    ``phase_cb(name)`` (a context-manager factory) times the schedule's
    warmup / steady / cooldown phases; launchers pass ``repro_torch.timing``
    scope handles.
    """
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig()
    n_layers = stage_plan.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)
    # fixed featurization: embeddings are not trained, the stage stack is
    emb = torch.randn((vocab_size, width), generator=gen, device=device) / width ** 0.5
    alpha = 1.0 / float(max(n_layers, 1))

    def layer_fn(w, a):
        return a + torch.tanh(a @ w[0]) @ w[1] * alpha

    def loss_fn(y, tgt):
        return ((y - tgt) ** 2).mean()

    pipeline = PipelineStep(
        layer_fn, loss_fn, mesh=mesh, axis=axis, n_micro=n_micro,
        phase_cb=phase_cb,
    )

    def init_params(generator=None):
        g = generator if generator is not None else gen
        layers = torch.randn((n_layers, 2, width, width), generator=g, device=device)
        return {"layers": layers * 0.3}

    def pipeline_call(params, batch):
        x = emb[batch["tokens"].long()]
        tgt = emb[batch["targets"].long()]
        packed, mask = stage_plan.pack(params["layers"])
        loss, packed_grads = pipeline(packed, x, tgt, stage_mask=mask)
        return loss, {"layers": stage_plan.unpack(packed_grads)}

    return PipelineBuiltStep(
        fn=_pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps),
        tokens_per_call=global_batch * seq_len,
        stage_plan=stage_plan,
        pipeline=pipeline,
        init_params=init_params,
        pipeline_call=pipeline_call,
    )


@timed("steps::make_transformer_pipeline_train_step")
def make_transformer_pipeline_train_step(
    cfg: ArchConfig,
    mesh: Mesh,
    stage_plan: StagePlan,
    *,
    axis: str = "pod",
    seq_len: int,
    global_batch: int,
    n_micro: int,
    opt_cfg: AdamWConfig | None = None,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    seed: int = 0,
    phase_cb: Any = None,
    device: str | torch.device = "cuda",
    rules: ShardingRules | None = None,
) -> PipelineBuiltStep:
    """Build a 1F1B train step over the *real* transformer stack of ``cfg``.

    One pipeline slot runs one block-pattern period of the model
    (``models.pipeline``): the stacked units are re-packed from the live
    ``stage_plan`` every step (a run-time ``restage`` moves stage boundaries
    on the next step), the token embedding is pinned to rank 0 and the
    final-norm + LM head + CE loss to the last rank via the schedule's
    ``first_fn``/``last_fn`` hooks, and the kernels selected by
    ``cfg.attn_impl``/``cfg.norm_impl`` dispatch inside the staged
    computation.  Params, optimizer state and batches live on ``device``.
    Stage-parameter specs compose the pipeline axis with ``rules``
    (``rules_for(cfg)`` by default; ``models.pipeline.stage_param_specs``):
    on a pod-only mesh every inner entry drops.
    """
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig()
    n_units = MP.check_pipelineable(cfg)
    if stage_plan.n_layers != n_units:
        raise ValueError(
            f"stage_plan covers {stage_plan.n_layers} units but {cfg.name} "
            f"has {n_units} pattern periods ({cfg.n_layers} layers / "
            f"{len(cfg.block_pattern)}-block pattern)"
        )
    layer_fn, first_fn, last_fn = MP.make_stage_fns(cfg)
    stage_spec = MP.stage_param_specs(cfg, mesh, rules if rules is not None else rules_for(cfg),
                                      axis)
    pipeline = PipelineStep(
        layer_fn, None, mesh=mesh, axis=axis, n_micro=n_micro,
        first_fn=first_fn, last_fn=last_fn, phase_cb=phase_cb, stage_spec=stage_spec,
    )

    def init_params(generator=None):
        g = generator if generator is not None else torch.Generator(
            device=device).manual_seed(seed)
        return M.init_params(cfg, g, device)

    def pipeline_call(params, batch):
        stack, first, last = MP.split_params(cfg, params)
        packed, mask = stage_plan.pack(stack)
        loss, (packed_grads, first_grads, last_grads) = pipeline(
            packed, batch["tokens"], batch["targets"], stage_mask=mask,
            first_params=first, last_params=last,
        )
        return loss, MP.merge_grads(cfg, stage_plan.unpack(packed_grads), first_grads,
                                    last_grads)

    return PipelineBuiltStep(
        fn=_pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps),
        tokens_per_call=global_batch * seq_len,
        stage_plan=stage_plan,
        pipeline=pipeline,
        init_params=init_params,
        pipeline_call=pipeline_call,
    )
