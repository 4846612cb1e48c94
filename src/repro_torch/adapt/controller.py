"""The control plane core: controllers, decisions, and the polling loop.

The paper's headline claim is that a timing infrastructure lets an application
"profile itself and dynamically adapt itself to a changing environment at run
time".  The measurement side (clocks, timers, cross-host reductions) lives in
:mod:`repro.core` and :mod:`repro.dist`; this module closes the loop:

* a :class:`Controller` is anything that reads measurements and decides — it
  names the timer-database channels it wants polled and returns zero or more
  :class:`ControlAction` records per step;
* the :class:`ControlLoop` is the registry and dispatcher: each
  :meth:`ControlLoop.poll` samples every registered controller's channels out
  of the :class:`~repro.core.timers.TimerDB` and hands them over, records each
  returned action in its decision log, and mirrors per-action counts into the
  database as ``ADAPT/<controller>::<action>`` rows so adaptation history
  renders in the Fig.-2 report next to every measured timer.

The loop is deliberately synchronous and schedulable: drive it from a Cactus
bin via :meth:`repro.core.schedule.Scheduler.attach_control_loop` (the
production path in ``repro.launch.train``) or call ``poll`` by hand in tests
and simulations.  Controllers in this package: checkpoint admission
(:mod:`repro.adapt.checkpoint`, the paper's AdaptCheck generalized) and
straggler response (:mod:`repro.adapt.stragglers`, rebalance/evict).
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Mapping, Sequence
from dataclasses import dataclass, field
from typing import NamedTuple, Protocol, runtime_checkable

from ..core.timers import TimerDB, timer_db

__all__ = ["Measurement", "ControlAction", "Controller", "ControlLoop"]


class Measurement(NamedTuple):
    """One polled timer-DB channel: accumulated seconds + window count."""

    seconds: float
    count: int


@dataclass(frozen=True)
class ControlAction:
    """One decision taken by a controller — the unit of the ``ADAPT/`` log.

    ``trigger`` names the timer-DB channel whose measurement caused the
    decision (e.g. ``DIST/host2::step``); ``action`` is the short verb
    (``rebalance``, ``evict``, ``checkpoint``); ``detail`` carries
    action-specific parameters for the report.
    """

    step: int
    controller: str
    trigger: str
    action: str
    detail: Mapping[str, object] = field(default_factory=dict)

    def describe(self) -> str:
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in self.detail.items())
        return f"[{self.controller}] step {self.step}: {self.action} <- {self.trigger} {parts}"


def _fmt(value: object) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


@runtime_checkable
class Controller(Protocol):
    """Anything the :class:`ControlLoop` can dispatch.

    ``channels`` lists the timer names this controller may read each poll;
    ``control`` receives them as a lazy mapping — a channel is sampled from
    the timer database only when the controller actually accesses it, so a
    controller that skips a poll (or consults richer sources, like the
    straggler controller's detector) costs zero timer reads.  ``control``
    returns the actions taken (empty when the controller decides to do
    nothing); the declared channels document the trigger surface and appear
    in every recorded action.
    """

    name: str
    channels: Sequence[str]

    def control(
        self, step: int, measurements: Mapping[str, Measurement]
    ) -> Iterable[ControlAction]: ...


class _LazyMeasurements(Mapping):
    """Mapping over a controller's declared channels, sampled on first access.

    ``ControlLoop.poll`` hands one of these to every controller: the locked
    timer-database reads happen only for channels the controller actually
    looks at this poll (cached per poll), so declaring a wide trigger surface
    — e.g. one ``DIST/host{h}::step`` channel per host on a large fleet — is
    free on the polls that skip it.
    """

    __slots__ = ("_measure", "_channels", "_cache")

    def __init__(self, measure, channels) -> None:
        self._measure = measure
        self._channels = tuple(channels)
        self._cache: dict[str, Measurement] = {}

    def __getitem__(self, name: str) -> Measurement:
        if name not in self._channels:
            raise KeyError(name)
        got = self._cache.get(name)
        if got is None:
            got = self._cache[name] = self._measure(name)
        return got

    def __iter__(self):
        return iter(self._channels)

    def __len__(self) -> int:
        return len(self._channels)


class ControlLoop:
    """Controller registry + dispatcher + ``ADAPT/`` decision log.

    Parameters
    ----------
    db:
        Timer database to poll channels from and publish decision rows into
        (defaults to the process-global database).
    prefix:
        Section prefix for published decision rows (``ADAPT``).
    publish:
        When true (default), every action increments an
        ``{prefix}/<controller>::<action>`` timer row so aggregate adaptation
        counts render in ``core.report.format_report``.
    on_action:
        Optional callback invoked with each recorded :class:`ControlAction`
        (launcher logging / alerting hook).
    """

    def __init__(
        self,
        db: TimerDB | None = None,
        prefix: str = "ADAPT",
        publish: bool = True,
        on_action: Callable[[ControlAction], None] | None = None,
    ) -> None:
        self._db = db if db is not None else timer_db()
        self.prefix = prefix
        self.publish = publish
        self.on_action = on_action
        self._controllers: list[Controller] = []
        #: every action ever recorded, in dispatch order — the ADAPT/ log
        self.actions: list[ControlAction] = []
        self.polls = 0

    @property
    def db(self) -> TimerDB:
        return self._db

    # -- registry ---------------------------------------------------------------
    def register(self, controller: Controller) -> Controller:
        """Add a controller; names must be unique within the loop."""
        name = getattr(controller, "name", None)
        if not name:
            raise ValueError(f"controller {controller!r} has no name")
        if any(c.name == name for c in self._controllers):
            raise ValueError(f"controller {name!r} already registered")
        self._controllers.append(controller)
        return controller

    def unregister(self, name: str) -> None:
        before = len(self._controllers)
        self._controllers = [c for c in self._controllers if c.name != name]
        if len(self._controllers) == before:
            raise ValueError(f"no controller named {name!r}")

    def controller(self, name: str) -> Controller:
        for c in self._controllers:
            if c.name == name:
                return c
        raise ValueError(f"no controller named {name!r}")

    def controllers(self) -> list[str]:
        return [c.name for c in self._controllers]

    # -- dispatch ---------------------------------------------------------------
    def _measure(self, channel: str) -> Measurement:
        if self._db.exists(channel):
            timer = self._db.get(channel)
            return Measurement(timer.seconds(), timer.count)
        return Measurement(0.0, 0)

    def poll(self, step: int) -> list[ControlAction]:
        """Dispatch every controller with lazily sampled channels; returns
        the actions taken this step (also appended to :attr:`actions`)."""
        self.polls += 1
        taken: list[ControlAction] = []
        for controller in list(self._controllers):
            measurements = _LazyMeasurements(
                self._measure, getattr(controller, "channels", ())
            )
            for action in controller.control(step, measurements) or ():
                self._record(action)
                taken.append(action)
        return taken

    def _record(self, action: ControlAction) -> None:
        self.actions.append(action)
        if self.publish:
            # cached path→timer resolution (repro.timing scope handles): the
            # locked create/lookup happens once per distinct action row
            scope = self._db.scope_handle(
                f"{self.prefix}/{action.controller}::{action.action}"
            )
            scope.timer.count += 1
        if self.on_action is not None:
            self.on_action(action)

    # -- reporting ---------------------------------------------------------------
    def actions_for(self, controller: str) -> list[ControlAction]:
        return [a for a in self.actions if a.controller == controller]

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for a in self.actions:
            key = f"{a.controller}::{a.action}"
            counts[key] = counts.get(key, 0) + 1
        return {
            "polls": self.polls,
            "controllers": self.controllers(),
            "n_actions": len(self.actions),
            "action_counts": counts,
        }
