"""Runtime adaptation — the control plane that turns timer measurements into
actions (the paper's "profile itself and dynamically adapt itself to a
changing environment at run time", Sec. 1 & 3).

The port carries the controller protocol, AdaptCheck checkpoint admission
(:class:`CheckpointControl`), straggler response (:class:`StragglerResponse`),
the serving controller, and :class:`SimulatedFleet`, an n-host simulation of
the whole loop in one process for tests and drills.
"""

from .checkpoint import CheckpointControl
from .controller import ControlAction, Controller, ControlLoop, Measurement
from .fleet import SimulatedFleet
from .serving import ServingControl
from .stragglers import StragglerResponse

__all__ = [
    "ControlAction",
    "Controller",
    "ControlLoop",
    "Measurement",
    "CheckpointControl",
    "ServingControl",
    "StragglerResponse",
    "SimulatedFleet",
]
