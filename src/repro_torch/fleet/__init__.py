"""Real multi-process fleets: transport, elastic membership, payback gates.

The simulated fleet (:class:`repro_torch.adapt.SimulatedFleet`) proved the
measure→decide→migrate loop in one process; this package runs the same loop
over **real subprocess ranks**:

* :mod:`~repro_torch.fleet.store` — the file-backed rendezvous substrate
  (atomic JSON keys + append-only JSONL logs, no external services);
* :mod:`~repro_torch.fleet.transport` — :class:`FleetTransport`, the
  cross-process ``publish``/``gather`` implementation of the
  :class:`~repro_torch.dist.stragglers.LocalTransport` surface, with
  heartbeats and epoch fencing so a partitioned or killed rank is *detected*,
  never assumed;
* :mod:`~repro_torch.fleet.membership` — :class:`Membership` (the
  epoch-fenced host registry over the shared
  :class:`~repro_torch.dist.pipeline.MicrobatchPlan`) and
  :class:`FleetController` (mid-run joins earn share, heartbeat-expired hosts
  leave through the checkpoint-before-evict barrier);
* :mod:`~repro_torch.fleet.payback` — :class:`ReshardCost` (measured
  save+restore seconds) and :class:`PaybackPolicy` (evict/join only when the
  projected win over the horizon covers the re-shard cost; every skip is an
  ``ADAPT/fleet::defer_reshard`` row);
* :mod:`~repro_torch.fleet.topology` — stage ownership as a pure function of
  (membership, stage count);
* :mod:`~repro_torch.fleet.worker` / :mod:`~repro_torch.fleet.launch` — the
  numpy-only rank main and the multi-process launcher
  (``python -m repro_torch.fleet.launch --hosts N``);
* :mod:`~repro_torch.fleet.drill` — the seeded rank-fault drill over the
  launcher (``python -m repro_torch.fleet.drill``).

Importing this package loads neither torch nor numpy (a rank must spawn
fast); the launcher imports the torch-adjacent control plane at call time.
"""

from .store import FileStore
from .topology import data_parallel_rank, stage_for_host
from .transport import FleetTransport

__all__ = [
    "FileStore",
    "FleetController",
    "FleetTransport",
    "Membership",
    "PaybackPolicy",
    "ReshardCost",
    "data_parallel_rank",
    "stage_for_host",
]

#: control-plane classes resolved lazily (PEP 562): they import
#: repro_torch.adapt, which loads torch — a worker subprocess must never pay
#: that at spawn
_LAZY = {
    "PaybackPolicy": "payback",
    "ReshardCost": "payback",
    "Membership": "membership",
    "FleetController": "membership",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
