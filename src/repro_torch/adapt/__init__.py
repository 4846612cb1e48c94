"""Runtime adaptation — the control plane that turns timer measurements into
actions (the paper's "profile itself and dynamically adapt itself to a
changing environment at run time", Sec. 1 & 3).

The port carries the controller protocol and the serving controller;
checkpoint admission, straggler response and the simulated fleet come with
the training and distribution slices.
"""

from .controller import ControlAction, Controller, ControlLoop, Measurement
from .serving import ServingControl

__all__ = [
    "ControlAction",
    "Controller",
    "ControlLoop",
    "Measurement",
    "ServingControl",
]
