"""Distributed substrate of the port: mesh utilities, cross-process timer
reductions, and pipeline parallelism.

``meshutil``   device meshes (``Mesh``, ``local_mesh``), eviction rebuild and
               per-stage pipeline submeshes
``stragglers`` cross-host step-time reduction + slow-host detection
``pipeline``   GPipe forward + 1F1B training schedules, microbatch/stage plans

Acting on what the reduction finds is orchestrated by
:mod:`repro_torch.adapt`.  The logical-axis sharding rules and the ambient
sharding context come with the rest of the distribution slice (ROADMAP
Queue 1 item 6).
"""

from .meshutil import Mesh, local_mesh, pipeline_submeshes, remove_host
from .pipeline import MicrobatchPlan, PipelineStep, StagePlan, phase_ticks, pipeline_step
from .stragglers import LocalTransport, StragglerDetector, StragglerReport

__all__ = [
    "Mesh",
    "local_mesh",
    "pipeline_submeshes",
    "remove_host",
    "MicrobatchPlan",
    "PipelineStep",
    "StagePlan",
    "phase_ticks",
    "pipeline_step",
    "LocalTransport",
    "StragglerDetector",
    "StragglerReport",
]
