"""Deterministic synthetic LM data.

Modes:
  * ``random`` — uniform tokens (throughput/dry-run benchmarking).
  * ``copy``   — first half random, second half repeats the first half with
    next-token targets; a learnable induction task (examples/train_llm.py).
  * ``skewed`` — Zipf-distributed tokens; the unigram statistics are learnable
    within tens of steps (fast integration tests).

Batches are a pure function of (seed, step), so any host can regenerate any
step — resuming from a checkpointed step id reproduces the exact stream
(elastic restarts included).  Modality stubs (frames/patches) are derived from
the same counter-based PRNG.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.config import ArchConfig

__all__ = ["SyntheticConfig", "SyntheticLM"]


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    mode: str = "copy"  # "copy" | "random" | "skewed"
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: SyntheticConfig, arch: ArchConfig | None = None) -> None:
        self.cfg = cfg
        self.arch = arch

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng(step)
        b, s, v = c.global_batch, c.seq_len, c.vocab_size
        if c.mode == "random":
            tokens = rng.integers(0, v, (b, s), dtype=np.int32)
        elif c.mode == "skewed":
            # Zipf-like unigram distribution: learnable within tens of steps
            # (the model only has to match token frequencies)
            probs = 1.0 / (np.arange(v) + 2.0)
            probs /= probs.sum()
            tokens = rng.choice(v, size=(b, s), p=probs).astype(np.int32)
        else:  # copy task
            half = s // 2
            prefix = rng.integers(0, v, (b, half), dtype=np.int32)
            tokens = np.concatenate([prefix, prefix[:, : s - half]], axis=1)
        targets = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1
        )
        if c.mode == "copy":
            # only score the (learnable) copied half
            half = s // 2
            masked = targets.copy()
            masked[:, : half - 1] = -1
            targets = masked
        batch = {"tokens": tokens, "targets": targets}
        if self.arch is not None:
            d = self.arch.d_model
            if self.arch.family == "vlm":
                p = self.arch.n_vision_patches
                batch["patch_embeds"] = rng.standard_normal((b, p, d)).astype(np.float32) * 0.02
            if self.arch.family == "encdec":
                batch["src_frames"] = rng.standard_normal((b, s, d)).astype(np.float32) * 0.02
        return batch
