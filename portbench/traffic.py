"""The one traffic generator: it reads a traffic file's parameters and makes
a run's inputs from ``--seed``.

``"kind": "train"``: each step is ``batch`` rows of ``text_len`` tokens drawn
uniformly from the vocabulary, with next-token targets (the last position
unscored); a vlm row also gets its patch embeddings (normal, ``patch_std``).
A step's patches are a window into one pool of normal numbers drawn once,
at an offset that moves by ``patch_stride_rows`` rows and one number a step
(modulo ``patch_shift_rows`` rows, from a start drawn from the seed): the
offsets of any two steps less than ``d_model`` apart differ by a number that
is no multiple of ``d_model``, so no patch vector of one step is one of
another's, while the host makes no array a step (the window is a view).
Step ``i`` is a pure function of (seed, i).

``"kind": "serve"``: an open loop of about ``rate x seconds`` requests (a
whole number of blocks), the rate fixed by the cell.  Every seed offers the
same multiset of prompt lengths (quantiles of the file's length
distribution) and the same arrivals (gaps that are quantiles of an
exponential of mean 1/rate, block by block, in one order for every seed);
the seed only orders the lengths and draws the prompts' tokens
(``serve_requests``).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["TrainData", "ServeRequest", "serve_requests", "length_quantiles"]


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**63 - 1), *key]))


class TrainData:
    """The batches of a training run, as the program's data loader hands them
    (numpy arrays): ``next()`` and ``close()``."""

    def __init__(self, spec: dict, run: dict, seed: int, start: int = 0) -> None:
        self.batch, self.text_len = spec["batch"], spec["text_len"]
        self.vocab = run["vocab_size"]
        self.seed = int(seed)
        self.step = int(start)
        self.patches = None
        n_patch = run.get("n_vision_patches", 0)
        if n_patch:
            d = run["d_model"]
            self.shape = (self.batch, n_patch, d)
            self.span = spec["patch_shift_rows"] * d
            self.stride = spec["patch_stride_rows"] * d + 1
            size = self.batch * n_patch * d
            self.patches = _rng(seed, 2).standard_normal(size + self.span, dtype=np.float32)
            self.patches *= np.float32(spec["patch_std"])
            self.start = int(_rng(seed, 5).integers(0, self.span))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = _rng(self.seed, 1, step)
        tokens = rng.integers(0, self.vocab, (self.batch, self.text_len), dtype=np.int32)
        targets = np.concatenate([tokens[:, 1:], np.full((self.batch, 1), -1, np.int32)], axis=1)
        out = {"tokens": tokens, "targets": targets}
        if self.patches is not None:
            off = (self.start + step * self.stride) % self.span
            size = self.shape[0] * self.shape[1] * self.shape[2]
            out["patch_embeds"] = self.patches[off:off + size].reshape(self.shape)
        return out

    def next(self) -> dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def close(self) -> None:
        pass


def length_quantiles(spec: dict, n: int) -> list[int]:
    """``n`` prompt lengths: the (i + 1/2)/n quantiles of the distribution."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


class ServeRequest:
    __slots__ = ("index", "due", "prompt")

    def __init__(self, index: int, due: float, prompt: list[int]) -> None:
        self.index, self.due, self.prompt = index, due, prompt


def serve_requests(spec: dict, run: dict, rate: float, seconds: float,
                   seed: int) -> list[ServeRequest]:
    """The open loop's requests in order of arrival; ``due`` is seconds from
    the window's start, the gaps summing to ``seconds``.

    The arrivals come in blocks of ``spec["block"]`` requests, every block
    holding the same gaps (the block's quantiles of an exponential of mean
    1/rate) in an order that is the same for every seed, so every seed
    offers the same arrivals.  Each block gets one length from each of
    ``block`` strata of the lengths (shortest to longest); the seed picks
    which length of each stratum goes to which block and orders each block's
    lengths, and draws the tokens.  So the seed cannot pile a run's long
    prompts into one burst: every seed's tail has the same work in front of
    it, in another order."""
    k = spec["block"]
    n = max(int(round(rate * seconds / k)), 1) * k
    lengths = np.array(sorted(length_quantiles(spec["text_len"], n)))
    strata = lengths.reshape(k, n // k)  # row j: the j-th shortest n/k lengths
    block_gaps = np.array([-math.log(1.0 - (i + 0.5) / k) / rate for i in range(k)])
    rng, fixed = _rng(seed, 3), _rng(0, 6)
    picks = np.stack([rng.permutation(n // k) for _ in range(k)])  # stratum -> block order
    order_len, gaps = [], []
    for b in range(n // k):
        order_len.extend(strata[np.arange(k), picks[:, b]][rng.permutation(k)])
        gaps.extend(block_gaps[fixed.permutation(k)])
    gaps = np.array(gaps) * (seconds / sum(block_gaps) / (n // k))  # they fill the window
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    out = []
    for i in range(n):
        tokens = _rng(seed, 4, i).integers(0, run["vocab_size"], int(order_len[i]),
                                            dtype=np.int64)
        out.append(ServeRequest(i, float(due[i]), tokens.tolist()))
    return out
