"""Distributed substrate of the port: cross-process timer reductions and the
framework-free fleet assignment plans.

``stragglers`` cross-host step-time reduction + slow-host detection
``pipeline``   microbatch/stage plans

Acting on what the reduction finds is orchestrated by
:mod:`repro_torch.adapt`.  The sharding rules, meshes and the pipeline
schedules themselves come with the distribution slice (ROADMAP Queue 1).
"""

from .pipeline import MicrobatchPlan, StagePlan
from .stragglers import LocalTransport, StragglerDetector, StragglerReport

__all__ = [
    "MicrobatchPlan",
    "StagePlan",
    "LocalTransport",
    "StragglerDetector",
    "StragglerReport",
]
