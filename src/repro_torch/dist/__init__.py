"""Distributed substrate of the port: logical-axis sharding, mesh utilities,
cross-process timer reductions, and pipeline parallelism.

The package mirrors the paper's scaling story (Sec. 1: timing infrastructure
"for large-scale simulations ... distributed over many processors"): model
code annotates tensors with *logical* axis names, :mod:`.sharding` maps them
onto the axes of a ``DeviceMesh`` of real processes (DTensor placements),
and :mod:`.stragglers` aggregates per-host step walltimes from the timer
database — the Cactus-style cross-process timer reduction that lets a run
profile itself and adapt.

``sharding``    logical-axis rules -> ``PartitionSpec`` -> DTensor placements
``context``     ambient (mesh, rules) context, ``constrain`` annotations and
                the kernel boundary (``local_apply``)
``meshutil``    device meshes: ``Mesh``/``local_mesh`` for the single-
                controller pipeline, ``device_mesh`` over a process group,
                eviction rebuild and per-stage pipeline submeshes
``collectives`` the routed, counted and timed collectives of a gloo mesh
``stragglers``  cross-host step-time reduction + slow-host detection
``pipeline``    GPipe forward + 1F1B training schedules, microbatch/stage plans

Acting on what the reduction finds is orchestrated by
:mod:`repro_torch.adapt`.
"""

from .context import constrain, current_sharding, use_sharding
from .meshutil import Mesh, device_mesh, local_mesh, pipeline_submeshes, remove_host
from .pipeline import MicrobatchPlan, PipelineStep, StagePlan, phase_ticks, pipeline_step
from .sharding import (
    DEFAULT_RULES,
    FSDP_RULES,
    Axes,
    PartitionSpec,
    ShardingRules,
    distribute_tree,
    gather_tree,
    placements_for,
    spec_for,
    tree_shardings,
)
from .stragglers import LocalTransport, StragglerDetector, StragglerReport

__all__ = [
    "Axes",
    "PartitionSpec",
    "ShardingRules",
    "DEFAULT_RULES",
    "FSDP_RULES",
    "spec_for",
    "placements_for",
    "tree_shardings",
    "distribute_tree",
    "gather_tree",
    "use_sharding",
    "current_sharding",
    "constrain",
    "Mesh",
    "local_mesh",
    "device_mesh",
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
