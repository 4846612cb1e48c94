"""Deterministic, seedable fault plans.

A :class:`FaultPlan` is a replayable schedule of :class:`FaultEvent` records —
*which* failure hits *what* at *which* step.  Determinism is the whole point:
a soak run that found a recovery bug must be re-runnable byte-for-byte from
its seed, and every injector that needs randomness (which bit to flip, where
to truncate) draws from a per-event RNG derived from ``(seed, step, kind,
target)`` so replaying one event never depends on how many events ran before
it.

Event kinds (targets in parentheses):

======================  =======================================================
``bitflip``             flip one bit of a checkpoint leaf (leaf index)
``truncate_leaf``       cut a leaf file short (leaf index)
``drop_leaf``           delete a leaf file outright (leaf index)
``drop_manifest``       delete ``manifest.json``
``partial_manifest``    truncate the manifest mid-JSON (a writer crash between
                        leaf writes and commit)
``drop_commit``         delete the COMMIT marker
``kill_writer``         leave the stale ``.tmp`` debris of a writer killed
                        mid-write (partial leaves, no manifest, no commit)
``sigterm``             SIGTERM the process with a save deadline (arg=seconds)
``slow_host``           multiply a fleet host's per-unit cost (host, arg=factor)
``hang_host``           effectively stop a fleet host (host; arg=factor,
                        default 1000x)
``restore_host``        clear injected slowdowns on a host (host)
``kill_rank``           SIGKILL a real subprocess rank (host)
``hang_rank``           SIGSTOP a real subprocess rank — heartbeats stop but
                        the process lives (host)
``rejoin_rank``         launch a fresh rank that requests admission (host =
                        new host id)
``slow_rank``           throttle a real rank's step pacing (host, arg=factor)
======================  =======================================================
"""

from __future__ import annotations

import hashlib
import random
from collections.abc import Iterable, Sequence
from dataclasses import dataclass

__all__ = [
    "CHECKPOINT_FAULTS",
    "FLEET_FAULTS",
    "RANK_FAULTS",
    "FaultEvent",
    "FaultPlan",
    "seeded_rng",
]

#: the corruption matrix the checkpoint layer must detect and recover past
CHECKPOINT_FAULTS: tuple[str, ...] = (
    "bitflip",
    "truncate_leaf",
    "drop_leaf",
    "drop_manifest",
    "partial_manifest",
    "drop_commit",
    "kill_writer",
)

#: environment faults against a (simulated) fleet
FLEET_FAULTS: tuple[str, ...] = ("slow_host", "hang_host", "restore_host")

#: process-level faults against *real* subprocess ranks (the fleet drill:
#: SIGKILL / SIGSTOP a live rank, admit a fresh one, throttle one's pacing)
RANK_FAULTS: tuple[str, ...] = ("kill_rank", "hang_rank", "rejoin_rank", "slow_rank")


def _seed_int(*parts: object) -> int:
    """Stable cross-process integer seed from structured parts (``hash()`` is
    salted per process; ``random.seed`` only accepts scalars)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "big")


def seeded_rng(*parts: object) -> random.Random:
    """Deterministic RNG keyed by structured parts — the standalone analogue
    of :meth:`FaultPlan.rng_for` for injections outside any plan."""
    return random.Random(_seed_int(*parts))


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: ``kind`` hits ``target`` at ``step``.

    ``target`` is a leaf index (checkpoint faults) or host id (fleet faults);
    ``arg`` is the kind-specific magnitude (slowdown factor, deadline
    seconds, truncate fraction).
    """

    step: int
    kind: str
    target: int | None = None
    arg: float | None = None

    def describe(self) -> str:
        bits = [f"step {self.step}: {self.kind}"]
        if self.target is not None:
            bits.append(f"target={self.target}")
        if self.arg is not None:
            bits.append(f"arg={self.arg:g}")
        return " ".join(bits)


class FaultPlan:
    """An ordered, seedable schedule of fault events.

    Build one explicitly from events, or draw a random-but-deterministic plan
    with :meth:`random`.  :meth:`at` returns the events due at a step;
    :meth:`rng_for` hands injectors their per-event RNG.
    """

    def __init__(self, events: Iterable[FaultEvent] = (), seed: int = 0) -> None:
        self.seed = int(seed)
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind, e.target if e.target is not None else -1))
        )

    @classmethod
    def random(
        cls,
        seed: int,
        n_steps: int,
        kinds: Sequence[str] = CHECKPOINT_FAULTS,
        rate: float = 0.05,
        hosts: Sequence[int] = (),
        max_leaf: int = 4,
    ) -> FaultPlan:
        """A deterministic plan: each step independently draws a fault with
        probability ``rate`` from ``kinds`` (fleet kinds target a random host
        from ``hosts``, checkpoint kinds a random leaf < ``max_leaf``)."""
        rng = random.Random(_seed_int("faultplan", seed))
        events: list[FaultEvent] = []
        for step in range(n_steps):
            if rng.random() >= rate:
                continue
            kind = rng.choice(list(kinds))
            if kind in FLEET_FAULTS or kind in RANK_FAULTS:
                if not hosts:
                    continue
                target = rng.choice(list(hosts))
                arg = (
                    round(rng.uniform(2.0, 8.0), 3)
                    if kind in ("slow_host", "slow_rank")
                    else None
                )
            elif kind == "sigterm":
                target, arg = None, round(rng.uniform(1.0, 10.0), 3)
            else:
                target = rng.randrange(max_leaf)
                arg = round(rng.uniform(0.1, 0.9), 3) if kind == "truncate_leaf" else None
            events.append(FaultEvent(step=step, kind=kind, target=target, arg=arg))
        return cls(events, seed=seed)

    def at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def rng_for(self, event: FaultEvent) -> random.Random:
        """Per-event RNG: independent of plan order, stable across replays."""
        return random.Random(_seed_int(self.seed, event.step, event.kind, event.target))

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def describe(self) -> str:
        return "\n".join(e.describe() for e in self.events) or "(no events)"
