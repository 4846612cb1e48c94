"""The yardstick's arithmetic: the work a step or a request needs, counted
from the configuration's sizes alone, and the chip's published peaks.

Counting rules, the same whatever implements the work:

* matmul FLOPs are 2 x (the parameters a position touches) a position in a
  forward pass and 6 x in training: the attention projections, the MLP or
  the routed experts at top_k of n_experts (and the router), and the head,
  which a training step applies at the scored (text) positions and a prefill
  at its last position;
* attention adds its score and value products over the unmasked (query,
  key) pairs: 4 x head_dim FLOPs a pair and head forward, twice that
  backward; the recompute of the scores is not counted;
* bytes: each input read once, each output written once;
* recomputation (remat) and capacity padding are never counted.

The peaks are NVIDIA's data sheet for one H100 SXM (dense bf16 tensor
rate, HBM3 bandwidth), as ``chip_smoke.py`` states them.
"""

from __future__ import annotations

__all__ = [
    "PEAK_BF16_FLOPS",
    "HBM_BYTES_PER_S",
    "layer_params",
    "train_step_flops",
    "prefill_flops",
    "attention_fwd",
    "attention_bwd",
    "least_seconds",
]

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_params(run: dict) -> int:
    """Parameters one position touches in one layer (matmul weights only)."""
    d, hd = run["d_model"], run["head_dim"]
    q, kv = run["n_heads"] * hd, run["n_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    moe = run.get("moe")
    if moe:
        ffn = moe["top_k"] * 3 * d * moe["d_expert"] + d * moe["n_experts"]
    else:
        ffn = 3 * d * run["d_ff"]
    return attn + ffn


def _causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attention_fwd(run: dict, batch: int, n: int, layers: int) -> tuple[float, float]:
    """(FLOPs, bytes) of causal attention forward over ``batch`` sequences of
    ``n`` positions in ``layers`` layers: q, k, v read and o written in the
    served type, the f32 log-sum-exp written."""
    hd, h, kvh = run["head_dim"], run["n_heads"], run["n_kv_heads"]
    elt = 2 if run["dtype"] == "bfloat16" else 4
    flops = 4.0 * hd * h * _causal_pairs(n) * batch * layers
    bytes_ = (elt * batch * n * hd * (2 * h + 2 * kvh) + 4 * batch * h * n) * layers
    return flops, float(bytes_)


def attention_bwd(run: dict, batch: int, n: int, layers: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention backward: twice the forward's
    products; q, k, v, o, do and the log-sum-exp read, dq, dk, dv written."""
    hd, h, kvh = run["head_dim"], run["n_heads"], run["n_kv_heads"]
    elt = 2 if run["dtype"] == "bfloat16" else 4
    flops = 2.0 * attention_fwd(run, batch, n, layers)[0]
    reads = elt * batch * n * hd * (3 * h + 2 * kvh) + 4 * batch * h * n
    writes = elt * batch * n * hd * (h + 2 * kvh)
    return flops, float((reads + writes) * layers)


def train_step_flops(run: dict, batch: int, text_len: int, layers: int) -> dict[str, float]:
    """Model FLOPs of one training step: ``batch`` sequences of the patch
    prefix (vlm) and ``text_len`` text tokens; the head at the text positions."""
    n = run.get("n_vision_patches", 0) + text_len
    positions = batch * n
    matmul = 6.0 * layer_params(run) * layers * positions
    head = 6.0 * run["d_model"] * run["vocab_size"] * batch * text_len
    attn = 3.0 * attention_fwd(run, batch, n, layers)[0]
    return {"matmul": matmul, "head": head, "attention": attn,
            "total": matmul + head + attn, "positions": float(positions)}


def prefill_flops(run: dict, text_len: int, layers: int) -> float:
    """Model FLOPs of one request's prefill (patch prefix + ``text_len``
    tokens, the head at the last position)."""
    n = run.get("n_vision_patches", 0) + text_len
    return (2.0 * layer_params(run) * layers * n + 2.0 * run["d_model"] * run["vocab_size"]
            + attention_fwd(run, 1, n, layers)[0])


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, bytes_ / HBM_BYTES_PER_S)
