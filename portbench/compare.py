"""The numbers that decide ``correct``, each held to its limit in the cell's
file (``workloads/<cell>.json``, ``limits``).

Training (three checked steps, the program against the f32 reference; a
cell compares the numbers its limits name):

* ``loss_gap``: the largest |program - reference| / |reference| of the
  three steps' losses;
* ``grad_gap``: the worst leaf's gap between the norms of the first step's
  gradient, |program - reference|, over the larger of that leaf's reference
  norm and the median leaf's;
* ``delta_gap``: the same for each leaf's change after the third step, over
  the leaves whose first reference gradient is at least a thousandth of
  the median leaf's (a leaf the loss barely reaches moves under Adam by
  round-off alone);
* ``grad_diff_median``: the median leaf's |program - reference| / |reference|
  of the first gradient itself (the norm of the difference) over the leaves
  both sides kept (``grad_full``: all but the expert stacks).  Under sparse
  experts bf16 rounding flips near-tied routes, and a flipped route moves
  the router's and the experts' gradients, and every leaf's worst-leaf and
  norm numbers, about as far as fp8 does.

Serving: ``logit_gap``, the widest gap by which a served token's reference
logit lies below the reference's best, over the sampled requests.
"""

from __future__ import annotations

import statistics

__all__ = ["leaf_gaps", "train_numbers", "serve_numbers", "DELTA_MIN_GRAD"]

DELTA_MIN_GRAD = 1e-3
#: the gap of a token outside the vocabulary
UNSERVED = 1e30


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keys=None) -> dict[str, float]:
    """Each leaf's gap between the norms over the larger of its reference
    norm and the median leaf's."""
    keys = list(ref) if keys is None else list(keys)
    missing = [k for k in keys if k not in prog]
    if missing:
        raise KeyError(f"the program has no leaf {missing[:3]}")
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _top(gaps: dict[str, float], n: int = 3) -> list[list]:
    return [[k, gaps[k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def train_numbers(prog: dict, ref: dict, worst: dict | None = None) -> dict[str, float]:
    """Every training number (a cell compares those its limits name);
    ``worst``, when given, gets the three worst leaves of each worst-leaf
    gap, with their gaps."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"], strict=True))
    median_grad = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= DELTA_MIN_GRAD * median_grad]
    grad = leaf_gaps(prog["grad"], ref["grad"])
    delta = leaf_gaps(prog["delta"], ref["delta"], moving)
    if worst is not None:
        worst.update(grad_gap=_top(grad), delta_gap=_top(delta))
    out = {"loss_gap": loss, "grad_gap": max(grad.values()), "delta_gap": max(delta.values())}
    if "grad_full" in prog and "grad_full" in ref:
        p, r = prog["grad_full"], ref["grad_full"]
        out["grad_diff_median"] = statistics.median(
            float((p[k] - r[k]).norm() / r[k].norm().clamp_min(1e-30)) for k in r)
    return out


def serve_numbers(tokens: list[int], ref_logits: list) -> dict[str, float]:
    gaps = [float(lg.max() - lg[tok]) if 0 <= tok < lg.shape[0] else float(UNSERVED)
            for tok, lg in zip(tokens, ref_logits, strict=True)]
    return {"logit_gap": max(gaps)}
