"""Observability soak harness: wall-clock train/serve drives with fault
injection, periodic ``/metrics`` scrapes, and long-run boundedness invariants
(see :mod:`repro_torch.soak.run` for the CLI: ``python -m repro_torch.soak``)."""

from .invariants import SnapshotRecord, check_snapshots
from .run import SoakConfig, SoakResult, main, run_soak

__all__ = [
    "SnapshotRecord",
    "SoakConfig",
    "SoakResult",
    "check_snapshots",
    "main",
    "run_soak",
]
