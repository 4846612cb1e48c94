"""Fault injection: deterministic failure schedules for drills, tests, soaks.

The harshest environment change a long-running adaptive application must
survive is failure — preemption, corrupted storage, a dead or wedged host.
This package makes failure a first-class, *replayable* input:

* :class:`FaultPlan` / :class:`FaultEvent` (:mod:`repro_torch.faults.plan`) —
  a seedable schedule of faults; every injector draws per-event randomness
  so a failing drill replays byte-for-byte from its seed;
* :mod:`repro_torch.faults.inject` — the injectors: checkpoint corruption
  (the full matrix the validation layer must catch), fleet degradation
  (slow/hang/restore a simulated host), and process preemption (SIGTERM
  with a save deadline);
* :mod:`repro_torch.faults.soak` — the nightly drill: train under a
  :class:`~repro_torch.adapt.fleet.SimulatedFleet` with injected faults,
  assert recovery and bounded timer/counter growth, then corrupt, kill and
  resume a checkpointed training run.
"""

from .inject import (
    apply_checkpoint_event,
    apply_fleet_event,
    bit_flip_leaf,
    drop_commit,
    drop_leaf,
    drop_manifest,
    partial_manifest,
    send_sigterm,
    simulate_writer_kill,
    truncate_leaf,
)
from .plan import CHECKPOINT_FAULTS, FLEET_FAULTS, FaultEvent, FaultPlan, seeded_rng

__all__ = [
    "CHECKPOINT_FAULTS",
    "FLEET_FAULTS",
    "FaultEvent",
    "FaultPlan",
    "apply_checkpoint_event",
    "apply_fleet_event",
    "bit_flip_leaf",
    "drop_commit",
    "drop_leaf",
    "drop_manifest",
    "partial_manifest",
    "seeded_rng",
    "send_sigterm",
    "simulate_writer_kill",
    "truncate_leaf",
]
