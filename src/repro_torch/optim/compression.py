"""Gradient compression for cross-pod reduction (distributed-optimization trick).

Two pieces, the reference's:

* **Error-feedback int8 quantization** (`ef_quantize` / `dequantize`): per-leaf
  symmetric int8 with an f32 scale; the quantization residual is carried in an
  error-feedback buffer added back before the next quantization, which keeps
  SGD/Adam convergence (Karimireddy et al. 2019 semantics).

* **Compressed cross-pod mean** (`cross_pod_mean_compressed`): each rank's
  own tree (its pod's gradient, or a DTensor's local shard) is quantized,
  and the int8 payload and f32 scales are all-gathered over the mesh axis
  ``axis_name`` of the ambient ``dist.context.use_sharding`` mesh and
  reduced locally — the counterpart of the reference's call inside
  ``shard_map`` over the ``pod`` axis.  For 2 pods this moves ~1 byte/param
  over the pod links instead of ~4 (bf16 ring all-reduce moves 2·2
  bytes/param).

The arithmetic is the reference's, in its order.  As in the reference,
nothing in training calls the compressed mean (only the reference's dry run
does).
"""

from __future__ import annotations

import torch

from ..dist.context import current_sharding, is_dtensor
from ..models.layers import tree_leaves, tree_map

__all__ = ["ef_quantize", "dequantize", "ef_init", "cross_pod_mean_compressed"]


def _q_leaf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(tree):
    """A zero f32 error-feedback buffer shaped like ``tree``."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def ef_quantize(tree, ef_buffer):
    """Quantize (tree + ef) to int8; returns (q_tree, scale_tree, new_ef)."""
    corrected = tree_map(lambda g, e: g.float() + e, tree, ef_buffer)
    pairs = [_q_leaf(c) for c in tree_leaves(corrected)]
    q_it, s_it = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    q = tree_map(lambda _: next(q_it), corrected)
    s = tree_map(lambda _: next(s_it), corrected)
    new_ef = tree_map(lambda c, qq, ss: c - _dq_leaf(qq, ss), corrected, q, s)
    return q, s, new_ef


def dequantize(q_tree, scale_tree):
    return tree_map(_dq_leaf, q_tree, scale_tree)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n * x.shape[0], ...) over ``group``: the functional all-gather, which
    a gloo mesh routes, counts and times (``dist.collectives``)."""
    n = torch.distributed.get_world_size(group)
    flat = x.reshape(1, *x.shape) if x.dim() == 0 else x
    out = torch.ops._c10d_functional.all_gather_into_tensor(flat.contiguous(), n,
                                                            group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


def cross_pod_mean_compressed(tree, ef_buffer, axis_name: str = "pod"):
    """EF-int8 mean over the mesh axis ``axis_name`` of the ambient sharding
    context (``use_sharding``); DTensor leaves contribute their local shards.

    Returns (mean_tree_f32, new_ef_buffer), plain tensors.
    """
    context = current_sharding()
    if context is None:
        raise RuntimeError("cross_pod_mean_compressed needs a use_sharding(mesh, rules) "
                           "context whose mesh has the axis to reduce over")
    mesh = context[0]
    group = mesh.get_group(axis_name)
    n = torch.distributed.get_world_size(group)
    local = tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)
    q, s, new_ef = ef_quantize(local, ef_buffer)

    def reduce_leaf(qq, ss):
        qg = _all_gather(qq, group).reshape((n,) + tuple(qq.shape))  # (pods, ...) int8
        sg = _all_gather(ss, group)                                  # (pods,) f32
        dq = qg.float() * sg.reshape((-1,) + (1,) * qq.dim())
        return torch.sum(dq, dim=0) / n

    mean = tree_map(reduce_leaf, q, s)
    return mean, new_ef
