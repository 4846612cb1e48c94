"""Steerable parameters (paper Sec. 5: "Cactus applications are automatically
enabled with steerable parameters").

A process-global registry of typed parameters.  Parameters declared
``steerable=True`` may be changed while the run is live (e.g. from the
monitoring interface or a controller routine); non-steerable parameters are
frozen after the STARTUP bin runs.  Changes are validated and recorded with the
iteration at which they took effect, so the report can correlate behaviour
changes with steering events.
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any


__all__ = ["Param", "ParamRegistry", "param_registry", "reset_param_registry"]


class ParamError(RuntimeError):
    pass


@dataclass
class Param:
    name: str
    value: Any
    steerable: bool = False
    doc: str = ""
    validator: Callable[[Any], bool] | None = None
    history: list[tuple[int, Any]] = field(default_factory=list)


class ParamRegistry:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._params: dict[str, Param] = {}
        self._frozen = False

    def declare(
        self,
        name: str,
        default: Any,
        *,
        steerable: bool = False,
        doc: str = "",
        validator: Callable[[Any], bool] | None = None,
    ) -> Param:
        with self._lock:
            if name in self._params:
                return self._params[name]
            if validator is not None and not validator(default):
                raise ParamError(f"default for {name!r} fails validation")
            param = Param(name, default, steerable, doc, validator)
            self._params[name] = param
            return param

    def freeze(self) -> None:
        """Called after STARTUP: non-steerable params become immutable."""
        with self._lock:
            self._frozen = True

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._params:
                raise ParamError(f"unknown parameter {name!r}")
            return self._params[name].value

    def set(self, name: str, value: Any, iteration: int = -1) -> None:
        with self._lock:
            if name not in self._params:
                raise ParamError(f"unknown parameter {name!r}")
            param = self._params[name]
            if self._frozen and not param.steerable:
                raise ParamError(f"parameter {name!r} is not steerable")
            if param.validator is not None and not param.validator(value):
                raise ParamError(f"value {value!r} fails validation for {name!r}")
            param.history.append((iteration, param.value))
            param.value = value

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._params)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {name: p.value for name, p in self._params.items()}

    def describe(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "name": p.name,
                    "value": p.value,
                    "steerable": p.steerable,
                    "doc": p.doc,
                    "n_changes": len(p.history),
                }
                for p in self._params.values()
            ]


_REGISTRY = ParamRegistry()


def param_registry() -> ParamRegistry:
    return _REGISTRY


def reset_param_registry() -> ParamRegistry:
    global _REGISTRY
    _REGISTRY = ParamRegistry()
    return _REGISTRY
