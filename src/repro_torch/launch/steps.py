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
the model's ``constrain`` calls and its kernel boundaries apply.

The prefill and serve steps (:func:`make_prefill_step`,
:func:`make_serve_step`) run ``M.prefill`` / ``M.decode_step`` without
gradients and, on a ``DeviceMesh`` of more than one rank, under the sharding
context: every input that is not yet a DTensor is laid out first, each rank
keeping its own shard of the full tensor it holds (params by ``param_axes``,
the batch by :func:`batch_axes`, the cache by ``cache_axes``), so nothing
moves; the cache comes back as DTensors updated on each rank's shards and
the logits as a DTensor.  :func:`input_specs` gives each cell's inputs as
``PSpec`` stand-ins (shape, dtype, logical axes; nothing allocated), and a
:class:`BuiltStep` carries what the dry run (``launch.dryrun``) reads:
those stand-ins, the state's, and the ``PartitionSpec`` of every input.

The pipeline steps run on a single controller's ``Mesh`` or, one process a
rank, on a 1-d ``("pod",)`` ``DeviceMesh`` (``dist.pipeline``).  There each
rank's ``init_params`` draws the whole tree from the seed, as every rank of
a sharded run does, and keeps its share (``dist.pipeline_state.RankShare``:
its units, its pinned pieces); ``pipeline_call`` runs the rank's own units
and returns its share of the gradient; the step clips by the whole model's
norm (``RankShare.clip_norm``, which every rank takes bit for bit as the
single controller does) and updates the rank's own leaves; and a restage
moves units, with their optimizer state, between ranks before the step
that runs the new plan.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import torch

from ..dist.context import is_dtensor, use_sharding
from ..dist.pipeline import PipelineStep, StagePlan
from ..dist.pipeline_state import RankShare, clip_norm
from ..dist.sharding import (
    DEFAULT_RULES,
    FSDP_RULES,
    Axes,
    ShardingRules,
    distribute_tree,
    tree_shardings,
)
from ..models import model as M, pipeline as MP
from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import PSpec, axes_tree, tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_update, warmup_cosine
from ..timing import timed

__all__ = [
    "rules_for",
    "input_specs",
    "batch_axes",
    "shardings_for",
    "abstract_opt_state",
    "BuiltStep",
    "PipelineBuiltStep",
    "make_train_step",
    "make_pipeline_train_step",
    "make_transformer_pipeline_train_step",
    "make_prefill_step",
    "make_serve_step",
    "build_step",
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


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """``PSpec`` stand-ins (shape, dtype and logical axes; nothing
    allocated) for the step inputs of this cell, the reference's shapes and
    dtypes: a vlm's text is ``seq_len - n_vision_patches`` long behind its
    bf16 patches; an encdec prefill takes one BOS token a row beside
    ``seq_len`` bf16 source frames; a decode step one token a row and the
    ``seq_len``-long cache (``M.cache_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    axes = batch_axes(cfg, shape.kind)

    def spec(name, dims, dtype):
        return PSpec(dims, tuple(axes.get(name, ("batch",) + (None,) * (len(dims) - 1))),
                     init="zeros", dtype=dtype)

    text = s - cfg.n_vision_patches if cfg.family == "vlm" else s
    if shape.kind == "train":
        out: dict[str, Any] = {"tokens": spec("tokens", (b, text), i32),
                               "targets": spec("targets", (b, text), i32)}
        if cfg.family == "vlm":
            out["patch_embeds"] = spec("patch_embeds", (b, cfg.n_vision_patches, cfg.d_model),
                                       bf16)
        if cfg.family == "encdec":
            out["src_frames"] = spec("src_frames", (b, s, cfg.d_model), bf16)
        return out
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            # encode seq_len source frames; prefill the decoder with BOS
            return {"tokens": spec("tokens", (b, 1), i32),
                    "src_frames": spec("src_frames", (b, s, cfg.d_model), bf16)}
        out = {"tokens": spec("tokens", (b, text), i32)}
        if cfg.family == "vlm":
            out["patch_embeds"] = spec("patch_embeds", (b, cfg.n_vision_patches, cfg.d_model),
                                       bf16)
        return out
    if shape.kind == "decode":
        return {"tokens": PSpec((b, 1), ("batch", None), init="zeros", dtype=i32),
                "cache": M.cache_specs(cfg, b, s)}
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def abstract_opt_state(opt_cfg: AdamWConfig, params_spec):
    """The optimizer state of ``init_opt_state`` as ``PSpec`` stand-ins:
    the int32 ``step`` and f32 moments (and master copy) shaped and laid
    out as the parameters."""
    f32 = lambda p: PSpec(p.shape, p.axes, init="zeros", dtype=torch.float32)  # noqa: E731
    state = {"step": PSpec((), (), init="zeros", dtype=torch.int32),
             "m": tree_map(f32, params_spec), "v": tree_map(f32, params_spec)}
    if opt_cfg.master_weights:
        state["master"] = tree_map(f32, params_spec)
    return state


def shardings_for(axes_tree_, shape_tree, mesh, rules: ShardingRules):
    """``PartitionSpec`` of every leaf of an axes tree against a matching tree
    of shapes (``dist.sharding.tree_shardings``)."""
    return tree_shardings(axes_tree_, shape_tree, mesh, rules)


@dataclass
class BuiltStep:
    #: ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``; a
    #: prefill step's ``fn(params, batch, cache) -> (cache, logits)``, a
    #: serve step's ``fn(params, cache, tokens) -> (cache, logits)``
    fn: Callable[..., Any]
    #: tokens consumed per invocation — launchers feed this into the "tokens"
    #: counter channel (one counter_cell bump per executed step)
    tokens_per_call: int = 0
    #: ``PSpec`` stand-ins of the positional inputs after the state (the
    #: batch; the batch and cache of a prefill; the cache and tokens of a
    #: decode step)
    abstract_inputs: tuple = ()
    #: ``PartitionSpec`` trees of every positional input, state first
    #: (None without a mesh)
    in_shardings: tuple = ()
    #: ``{"params": ...}``, and ``"opt_state"`` for training, as ``PSpec``
    #: stand-ins
    abstract_state: dict[str, Any] = field(default_factory=dict)


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
    sharded = _is_sharded(mesh)
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

    p_abs = M.abstract_params(cfg)
    o_abs = abstract_opt_state(opt_cfg, p_abs)
    b_abs = input_specs(cfg, shape)
    return BuiltStep(fn=train_step, tokens_per_call=shape.global_batch * shape.seq_len,
                     abstract_inputs=(b_abs,),
                     in_shardings=tuple(_specs(t, mesh, rules) for t in (p_abs, o_abs, b_abs)),
                     abstract_state={"params": p_abs, "opt_state": o_abs})


def _specs(spec_tree, mesh, rules: ShardingRules):
    """``PartitionSpec`` of every ``PSpec`` of a tree on ``mesh`` (None
    without one)."""
    if mesh is None:
        return None
    return tree_shardings(axes_tree(spec_tree), spec_tree, mesh, rules)


def _is_sharded(mesh) -> bool:
    """A ``DeviceMesh`` of more than one rank."""
    return getattr(mesh, "mesh_dim_names", None) is not None and mesh.size() > 1


def _lay_out(tree, axes, mesh, rules: ShardingRules):
    """``tree`` with every plain leaf laid out by its logical axes (each
    rank keeps its shard of the full tensor it holds: nothing moves);
    DTensor leaves as they are."""
    from ..dist.context import is_dtensor

    return tree_map(lambda x, ax: x if is_dtensor(x) else distribute_tree(x, ax, mesh, rules),
                    tree, axes)


def _serving_fn(mesh, rules: ShardingRules, run, axes):
    """``fn(*args)``: ``run(*args)`` without gradients; on a sharded mesh
    with each arg laid out by its axes tree in ``axes`` first, and run
    under the sharding context."""
    sharded = _is_sharded(mesh)

    def fn(*args):
        with torch.no_grad():
            if not sharded:
                return run(*args)
            args = [_lay_out(a, ax, mesh, rules) for a, ax in zip(args, axes)]
            with use_sharding(mesh, rules):
                return run(*args)

    return fn


@timed("steps::make_prefill_step")
def make_prefill_step(cfg: ArchConfig, mesh: Any, rules: ShardingRules | None,
                      shape: ShapeConfig) -> BuiltStep:
    """``fn(params, batch, cache) -> (cache, last_logits)``: ``M.prefill``
    (module docstring).  The cache may be longer than the prompt, so decode
    steps can follow; the cell's stand-in cache is ``shape.seq_len`` long,
    as the reference's."""
    rules = rules if rules is not None else rules_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    p_abs, c_abs, b_abs = M.abstract_params(cfg), M.cache_specs(cfg, b, s), input_specs(cfg, shape)

    def run(params, batch, cache):
        return M.prefill(cfg, params, batch, cache)

    axes = (M.param_axes(cfg), axes_tree(b_abs), M.cache_axes(cfg, b, s))
    return BuiltStep(
        fn=_serving_fn(mesh, rules, run, axes), tokens_per_call=b * s,
        abstract_inputs=(b_abs, c_abs),
        in_shardings=tuple(_specs(t, mesh, rules) for t in (p_abs, b_abs, c_abs)),
        abstract_state={"params": p_abs})


@timed("steps::make_serve_step")
def make_serve_step(cfg: ArchConfig, mesh: Any, rules: ShardingRules | None,
                    shape: ShapeConfig) -> BuiltStep:
    """``fn(params, cache, tokens) -> (cache, logits)``: one
    ``M.decode_step`` of ``tokens`` (B, 1) against the cache (module
    docstring); the cell's stand-in cache is ``shape.seq_len`` long."""
    rules = rules if rules is not None else rules_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    p_abs, c_abs = M.abstract_params(cfg), M.cache_specs(cfg, b, s)
    tok_abs = input_specs(cfg, shape)["tokens"]

    def run(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens)

    axes = (M.param_axes(cfg), M.cache_axes(cfg, b, s), Axes(tok_abs.axes))
    return BuiltStep(
        fn=_serving_fn(mesh, rules, run, axes),
        tokens_per_call=b,  # one new token per sequence
        abstract_inputs=(c_abs, tok_abs),
        in_shardings=tuple(_specs(t, mesh, rules) for t in (p_abs, c_abs, tok_abs)),
        abstract_state={"params": p_abs})


def build_step(cfg: ArchConfig, mesh: Any, rules: ShardingRules | None, shape: ShapeConfig,
               **kw) -> BuiltStep:
    """The step of a shape cell: ``train`` -> :func:`make_train_step` (``kw``
    its options), ``prefill`` -> :func:`make_prefill_step`, ``decode`` ->
    :func:`make_serve_step`."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, mesh=mesh, rules=rules, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, rules, shape)
    return make_serve_step(cfg, mesh, rules, shape)


@dataclass
class PipelineBuiltStep(BuiltStep):
    """A :class:`BuiltStep` whose ``fn`` drives the 1F1B pipeline schedule.

    ``fn`` re-packs stage parameters from the live :class:`StagePlan` every
    step — that is what makes a run-time ``restage`` take effect on the very
    next step — and, when phase timing is on, runs warmup/steady/cooldown as
    separately synchronized segments.  ``init_params(generator=None)``
    draws the model's parameters on the step's device (in the process mode
    this rank's share of them); ``pipeline_call(params, batch) -> (loss,
    grads)`` is the step without the optimizer.  ``share`` is the process
    mode's :class:`~repro_torch.dist.pipeline_state.RankShare` (``None`` on
    the single controller).
    """

    stage_plan: StagePlan | None = None
    pipeline: PipelineStep | None = None
    init_params: Callable[..., Any] | None = None
    pipeline_call: Callable[..., Any] | None = None
    share: RankShare | None = None


def _rank_share(pipeline: PipelineStep, spec, stacked: str, owners, plan: StagePlan):
    """The process mode's :class:`RankShare` of ``pipeline``'s rank (None
    on the single controller)."""
    pr = pipeline.procs
    if pr is None:
        return None
    return RankShare(spec, stacked, owners, plan, pr.rank, pr.size, pr.transport, pr.peers)


def _check_layout(share: RankShare) -> None:
    if share.plan.boundaries() != share.bounds:
        raise RuntimeError(
            f"the stage plan moved units ({share.bounds} -> {share.plan.boundaries()}): "
            f"restage the rank's trees (RankShare.restage) before the next pipeline call")


def _tied_swap(share: RankShare, half, tokens: torch.Tensor):
    """Trade the tied table's gradient halves between the end ranks: the
    last rank sends its half (the head's, dense) whole; rank 0 sends only
    the rows of its half (the lookup's) that the batch's tokens touch, the
    rest being exact zeros, which the last rank puts back.  Either way each
    end rank gets the other's half bit for bit."""
    rows = torch.unique(tokens.long()).to(share.device)
    table = half["tokens"]
    if share.rank == 0:
        return share.swap({"tokens": table.index_select(0, rows)}, share.n_stages - 1,
                          like=half)
    got = share.swap(half, 0, like={"tokens": table.new_empty((rows.numel(),) +
                                                                 tuple(table.shape[1:]))})
    return {"tokens": torch.zeros_like(table).index_copy_(0, rows, got["tokens"])}


def _pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps, share,
                       stacked):
    """``fn(params, opt_state, batch)``: in the process mode a restage's
    moves first when the plan changed; ``pipeline_call(params, batch) ->
    (loss, grads)``; then AdamW at ``warmup_cosine`` of the state's step,
    clipped by the whole model's ``clip_norm``."""

    def train_fn(params, opt_state, batch):
        if share is not None:
            params, opt_state = share.restage(params, opt_state)
        loss, grads = pipeline_call(params, batch)
        lr = warmup_cosine(
            opt_state["step"], peak_lr=peak_lr, warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
        gnorm = share.clip_norm(grads) if share is not None else clip_norm(grads, stacked)
        params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state, lr,
                                                gnorm=gnorm)
        metrics = {"loss": loss, "lr": lr}
        metrics.update(stats)
        return params, opt_state, metrics

    return train_fn


@timed("steps::make_pipeline_train_step")
def make_pipeline_train_step(
    mesh: Any,
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
    optimizer state and batches live on ``device``.  ``mesh`` is a single
    controller's ``Mesh`` or a ``DeviceMesh`` of one process a rank (module
    docstring).

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
    spec = {"layers": torch.empty((n_layers, 2, width, width), device="meta")}
    share = _rank_share(pipeline, spec, "layers", {}, stage_plan)

    def init_params(generator=None):
        g = generator if generator is not None else gen
        layers = torch.randn((n_layers, 2, width, width), generator=g, device=device)
        params = {"layers": layers * 0.3}
        return params if share is None else share.cut(params)

    def pipeline_call(params, batch):
        x = emb[batch["tokens"].long()]
        tgt = emb[batch["targets"].long()]
        if share is not None:  # this rank's own units are its slots
            _check_layout(share)
            loss, grads = pipeline(params["layers"], x, tgt)
            return loss, {"layers": grads}
        packed, mask = stage_plan.pack(params["layers"])
        loss, packed_grads = pipeline(packed, x, tgt, stage_mask=mask)
        return loss, {"layers": stage_plan.unpack(packed_grads)}

    return PipelineBuiltStep(
        fn=_pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps,
                              share, "layers"),
        tokens_per_call=global_batch * seq_len,
        stage_plan=stage_plan,
        pipeline=pipeline,
        init_params=init_params,
        pipeline_call=pipeline_call,
        share=share,
    )


@timed("steps::make_transformer_pipeline_train_step")
def make_transformer_pipeline_train_step(
    cfg: ArchConfig,
    mesh: Any,
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
    on a pod-only mesh every inner entry drops.  ``mesh`` is a single
    controller's ``Mesh`` or a ``DeviceMesh`` of one process a rank (module
    docstring): there the tied table's two copies, on the end ranks, take
    the same gradient and so the same update.
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
    spec = M.abstract_params(cfg)
    act_dtype = spec["embed"]["tokens"].dtype  # the lookup's rows
    pipeline = PipelineStep(
        layer_fn, None, mesh=mesh, axis=axis, n_micro=n_micro,
        first_fn=first_fn, last_fn=last_fn, phase_cb=phase_cb, stage_spec=stage_spec,
        activation_spec=lambda tokens: ((*tokens.shape, cfg.d_model), act_dtype),
    )
    n_stages = pipeline.axis_size
    share = _rank_share(pipeline, spec, "scan", MP.piece_owners(cfg, n_stages), stage_plan)

    def init_params(generator=None):
        g = generator if generator is not None else torch.Generator(
            device=device).manual_seed(seed)
        params = M.init_params(cfg, g, device)
        return params if share is None else share.cut(params)

    def pipeline_call(params, batch):
        if share is None:
            stack, first, last = MP.split_params(cfg, params)
            packed, mask = stage_plan.pack(stack)
            loss, (packed_grads, first_grads, last_grads) = pipeline(
                packed, batch["tokens"], batch["targets"], stage_mask=mask,
                first_params=first, last_params=last,
            )
            return loss, MP.merge_grads(cfg, stage_plan.unpack(packed_grads), first_grads,
                                        last_grads)
        _check_layout(share)
        rank = share.rank
        stack, first, last = MP.split_params(cfg, params, rank=rank, n_stages=n_stages)
        loss, (stack_grads, first_grads, last_grads) = pipeline(
            stack, batch["tokens"], batch["targets"], first_params=first, last_params=last)
        return loss, MP.merge_grads(
            cfg, stack_grads, first_grads, last_grads, rank=rank, n_stages=n_stages,
            tied_peer=lambda half: _tied_swap(share, half, batch["tokens"]))

    return PipelineBuiltStep(
        fn=_pipeline_train_fn(pipeline_call, opt_cfg, peak_lr, warmup_steps, total_steps,
                              share, "scan"),
        tokens_per_call=global_batch * seq_len,
        stage_plan=stage_plan,
        pipeline=pipeline,
        init_params=init_params,
        pipeline_call=pipeline_call,
        share=share,
    )
