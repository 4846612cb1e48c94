"""Shared layer library: parameter specs, norms, rotary embeddings, MLPs.

Parameter handling convention
-----------------------------
Model code describes parameters with :class:`PSpec` trees (shape + logical axes
+ initializer).  ``materialize`` turns a spec tree into real tensors on an
explicit device from an explicit ``torch.Generator``; ``axes_tree`` extracts
the logical axes as ``dist.sharding.Axes`` leaves (the serving splicer finds
each cache leaf's batch axis with it; ``dist.sharding.tree_shardings``
resolves them against a mesh).  Trees are plain nested dicts/tuples/lists
with ``None`` holes, walked by :func:`tree_map`.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

__all__ = [
    "PSpec",
    "materialize",
    "axes_tree",
    "tree_map",
    "tree_leaves",
    "rms_norm",
    "rotary_embedding",
    "apply_rotary",
    "gated_mlp_specs",
    "gated_mlp",
]


@dataclass(frozen=True)
class PSpec:
    """Declarative parameter spec: shape, logical axes, init, dtype."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | const
    scale: float | None = None  # stddev for normal; default fan-in
    dtype: torch.dtype = torch.bfloat16
    const: float = 0.0  # fill value for init == "const"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PSpec shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts/tuples/lists (``None`` stays
    ``None``); ``rest`` trees are walked in lockstep with ``tree``.  A tuple
    whose class sets ``tree_leaf`` (``dist.sharding.Axes``,
    ``PartitionSpec``) is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not getattr(tree, "tree_leaf", False):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[Any]:
    leaves: list[Any] = []
    tree_map(leaves.append, tree)
    return leaves


def _fan_in(shape: Sequence[int]) -> int:
    # for stacked layer params the leading "layers" dim is not a fan-in dim;
    # use the second-to-last dim as fan-in (matmul convention: (..., in, out)).
    if len(shape) >= 2:
        return shape[-2]
    return max(shape[-1], 1)


#: normal leaves of more elements are drawn one leading-axis slice at a time
#: (16 GiB of f32 samples; every leaf of the configs registered before the
#: MoE family is below it and keeps its one-draw values)
MAX_DRAW_ELEMENTS = 1 << 32


def _draw_into(out: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    """Fill ``out`` with scaled standard normals, drawn whole when it has at
    most ``MAX_DRAW_ELEMENTS`` elements, else slice by slice along its
    leading axis."""
    if out.numel() > MAX_DRAW_ELEMENTS and out.dim() > 1:
        for part in out:
            _draw_into(part, generator, scale)
        return
    x = torch.randn(out.shape, generator=generator, device=generator.device)
    out.copy_(x.mul_(scale))


def materialize(
    specs, generator: torch.Generator | None, device: str | torch.device = "cuda"
):
    """Instantiate a PSpec tree into tensors on ``device``.

    Normal leaves draw f32 samples from ``generator`` (on the generator's own
    device, so a CUDA generator fills the full-width model without a host
    round trip), scale them in place and cast to the spec dtype, as the
    reference does.  A leaf of more than ``MAX_DRAW_ELEMENTS`` is drawn one
    leading-axis slice at a time into the allocated leaf, so initialising
    holds the weights plus one slice of f32 samples (moonshot-v1-16b-a3b's
    stacked experts would otherwise need 35 GB of f32 for one leaf).  Trees
    without normal leaves (caches) need no generator.
    """
    device = torch.device(device)

    def make(spec: PSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "const":
            return torch.full(spec.shape, spec.const, dtype=spec.dtype, device=device)
        if spec.init == "normal":
            scale = spec.scale if spec.scale is not None else _fan_in(spec.shape) ** -0.5
            out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
            _draw_into(out, generator, scale)
            return out
        raise ValueError(f"unknown init {spec.init!r}")

    return tree_map(make, specs)


def axes_tree(specs):
    """PSpec tree -> logical-axes tree (same structure, ``Axes`` leaves)."""
    from ..dist.sharding import Axes

    return tree_map(lambda s: Axes(s.axes), specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, cast back to input dtype.  A DTensor is normalized on
    each rank's local rows (``dist.context.local_rows``): its partial sums
    reduced once, in its own dtype, and its gradient reduced before the
    norm's backward (DTensor's own rules would keep the product, and the
    gradient behind it, partial)."""
    from ..dist.context import is_dtensor, local_rows

    if is_dtensor(x):
        return local_rows(lambda xl, wl: rms_norm(xl, wl, eps), x, weight)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any shape) -> (*pos.shape, head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., S, H, head_dim); cos/sin: (..., S, head_dim//2) broadcastable —
    typically (B, S, half) or (S, half).
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    # insert head axis for broadcast: cos (..., S, half) -> (..., S, 1, half)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def gated_mlp_specs(
    d_model: int, d_ff: int, dtype: torch.dtype, stack: tuple[int, ...] = ()
) -> dict[str, PSpec]:
    lead = tuple(stack)
    lax = ("layers",) * len(stack)
    return {
        "wi": PSpec(lead + (d_model, d_ff), lax + ("embed", "ffn"), dtype=dtype),
        "wg": PSpec(lead + (d_model, d_ff), lax + ("embed", "ffn"), dtype=dtype),
        "wo": PSpec(lead + (d_ff, d_model), lax + ("ffn", "embed"), dtype=dtype),
    }


def gated_mlp(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    up = x @ p["wi"]
    gate = x @ p["wg"]
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return hidden @ p["wo"]
