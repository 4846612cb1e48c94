"""Retention policy: ``keep_last_n`` + ``keep_every_k`` with safe GC.

The policy is pure arithmetic over step numbers (:meth:`RetentionPolicy.keeps`
/ :meth:`RetentionPolicy.doomed`) so it is testable without a filesystem; the
manager layers the one safety invariant that must never be policy-tunable on
top: **GC can never delete the newest valid checkpoint**, even when the
policy would — if the newest ``keep_last_n`` checkpoints all turn out corrupt,
the last-known-good one stays on disk no matter how old it is.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RetentionPolicy"]


@dataclass(frozen=True)
class RetentionPolicy:
    """Which checkpoint steps survive garbage collection.

    ``keep_last_n``: the newest N checkpoints always survive (0 keeps none on
    recency grounds alone).  ``keep_every_k``: additionally keep every
    checkpoint whose step is a multiple of K — the long-horizon archive rungs
    (0 disables).  A checkpoint survives if *either* rule keeps it.
    """

    keep_last_n: int = 3
    keep_every_k: int = 0

    def __post_init__(self) -> None:
        if self.keep_last_n < 0:
            raise ValueError(f"keep_last_n must be >= 0, got {self.keep_last_n}")
        if self.keep_every_k < 0:
            raise ValueError(f"keep_every_k must be >= 0, got {self.keep_every_k}")

    def keeps(self, steps: list[int]) -> set[int]:
        """The subset of ``steps`` the policy retains."""
        ordered = sorted(set(steps))
        kept = set(
            ordered[max(len(ordered) - self.keep_last_n, 0):] if self.keep_last_n else ()
        )
        if self.keep_every_k:
            kept.update(s for s in ordered if s % self.keep_every_k == 0)
        return kept

    def doomed(self, steps: list[int]) -> list[int]:
        """The steps GC may delete (ascending); the caller must still protect
        the newest *valid* checkpoint regardless of what this returns."""
        kept = self.keeps(steps)
        return [s for s in sorted(set(steps)) if s not in kept]

    def summary(self) -> dict[str, int]:
        return {"keep_last_n": self.keep_last_n, "keep_every_k": self.keep_every_k}
