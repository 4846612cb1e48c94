"""Per-device analysis of a step: collective operand bytes, matmul FLOPs,
live bytes and an op census — the port's counterpart of
``src/repro/launch/hlo.py``.

The reference parses the per-device HLO module that XLA's SPMD partitioner
wrote.  PyTorch runs eagerly, so the port records the ops a step runs below
DTensor, on this rank's local tensors: :class:`Recorder` is a
``TorchDispatchMode`` that passes every op holding a DTensor on
(``NotImplemented``: DTensor dispatches it, and the local ops it then runs,
its redistributions' functional collectives among them, come back through
the mode), and leaves out the ops DTensor's sharding propagation runs on
global shapes to infer an output's metadata (the propagator is marked while
it runs).  What it counts is therefore one rank's own work.

* ``collective_bytes(record)``: operand bytes of each functional collective,
  under the reference's opcode names (all-reduce, all-gather,
  reduce-scatter, all-to-all, collective-broadcast; point-to-point as
  collective-permute) — per-device bytes, as the reference's are;
* ``op_census(record)``: matmuls, kernel-wrapper calls (each kernel's plain
  version, which a wrapper takes on CPU tensors, counted under the kernel's
  name), copies and collectives, by name;
* ``record.flops``: the matmul FLOPs of the local ops
  (``torch.utils.flop_counter``'s formulas: mm, bmm, addmm, baddbmm,
  attention and convolution ops); inside the recurrence kernels none (their
  scans are elementwise: the recorder runs their parallel forms, which
  compute the same outputs, and counts no FLOPs there);
* ``record.peak_bytes``: the peak of this rank's live local bytes, the
  step's inputs included.  A kernel's plain version counts as the kernel:
  only its outputs are live after it (the flash kernel never holds the
  S x T scores its plain version builds), while its FLOPs are counted.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import Counter
from typing import Any

import torch

__all__ = ["Recorder", "collective_bytes", "op_census", "KERNEL_PLAIN"]

#: (ops module, plain version, kernel name, the parallel form the recorder
#: runs in its place or None) of every kernel wrapper: the recurrences'
#: plain versions step through the sequence one position at a time (32768
#: steps a layer in a prefill_32k cell), their parallel forms compute the
#: same function in a few dozen tensor operations
KERNEL_PLAIN = (
    ("flash_attention", "flash_fwd_plain", "flash_fwd", None),
    ("flash_attention", "flash_bwd_dq_plain", "flash_bwd_dq", None),
    ("flash_attention", "flash_bwd_dkv_plain", "flash_bwd_dkv", None),
    ("rmsnorm", "rms_norm_plain", "rmsnorm_fwd", None),
    ("rmsnorm", "rms_norm_bwd_plain", "rmsnorm_bwd", None),
    ("rglru", "rglru_fwd_plain", "rglru_fwd", "linear_recurrence_assoc"),
    ("rwkv6", "wkv6_fwd_plain", "wkv6_fwd", "wkv6_chunked"),
)

#: functional collective (``_c10d_functional`` / ``c10d`` op name) -> the
#: reference's HLO opcode
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "_scaled_mm"}
_COPIES = {"copy_", "_to_copy", "clone", "cat"}
_STATE = threading.local()


def _tensors(tree) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def _marked_propagation():
    """Mark the thread while DTensor's sharding propagator runs an op on
    global-shaped fakes to learn its output's metadata."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    original = getattr(ShardingPropagator, name, None)
    if original is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the recorder "
                           f"cannot tell propagation from the step's own ops")

    def marked(self, *args, **kwargs):
        depth = getattr(_STATE, "propagating", 0)
        _STATE.propagating = depth + 1
        try:
            return original(self, *args, **kwargs)
        finally:
            _STATE.propagating = depth

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


class Recorder:
    """Record one rank's local ops while a step runs (module docstring).
    ``inputs``: the step's arguments, live from the start.  After the
    ``with`` block: ``collectives`` (opcode -> operand bytes), ``calls``
    (op census), ``flops``, ``peak_bytes`` and ``argument_bytes``."""

    def __init__(self, inputs: Any = ()) -> None:
        self.collectives: Counter = Counter()
        self.calls: Counter = Counter()
        self.flops = 0
        self._live: dict[int, int] = {}
        self._refs: dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._opaque = 0  # > 0 inside a kernel's plain version
        self._scan = 0  # > 0 inside a recurrence kernel's parallel form
        self._stack = contextlib.ExitStack()
        for t in _tensors(inputs):
            self._track(_local(t))
        self.argument_bytes = self.live_bytes

    def _track(self, t: torch.Tensor) -> None:
        try:
            storage = t.untyped_storage()
        except (NotImplementedError, RuntimeError):  # no storage (a wrapper subclass)
            return
        key = storage._cdata
        if key in self._live:
            return
        self._live[key] = storage.nbytes()
        self.live_bytes += storage.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        def freed(_, key=key):
            self.live_bytes -= self._live.pop(key, 0)
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(storage, freed)

    def _op(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        namespace = func.namespace
        if namespace in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            payload = args[0]
            n = sum(t.numel() * t.element_size() for t in _tensors(payload))
            self.collectives[_COLLECTIVES[name]] += n
            self.calls[_COLLECTIVES[name]] += 1
        elif name in _MATMULS:
            self.calls["matmul"] += 1
        elif name in _COPIES:
            self.calls["copy"] += 1
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func._overloadpacket)
        if count is not None and not self._scan:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if not self._opaque:
            for t in _tensors(out):
                self._track(t)

    def _kernel(self, name: str, plain, parallel):
        scan = int(parallel is not None)

        def run(*args, **kwargs):
            self.calls[name] += 1
            self._opaque += 1
            self._scan += scan
            try:
                out = (parallel or plain)(*args, **kwargs)
            finally:
                self._opaque -= 1
                self._scan -= scan
            for t in _tensors(out):
                self._track(t)
            return out

        return run

    def __enter__(self) -> Recorder:
        import importlib

        recorder = self
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(_is_dtensor_type(t) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not getattr(_STATE, "propagating", 0):
                    recorder._op(func, args, kwargs, out)
                return out

        for module, plain, kernel, parallel in KERNEL_PLAIN:
            mod = importlib.import_module(f"..kernels.{module}.ops", __package__)
            original = getattr(mod, plain)
            self._stack.callback(setattr, mod, plain, original)
            setattr(mod, plain, self._kernel(kernel, original,
                                             parallel and getattr(mod, parallel)))
        self._stack.enter_context(_marked_propagation())
        self._stack.enter_context(_Mode())
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()


def _is_dtensor_type(t) -> bool:
    from ..dist.context import _dtensor_type

    cls = _dtensor_type()
    return cls is not None and issubclass(t, cls)


def _local(t: torch.Tensor) -> torch.Tensor:
    from ..dist.context import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def collective_bytes(record: Recorder) -> dict[str, int]:
    """Per-opcode summed operand bytes of the collectives one rank ran."""
    return dict(record.collectives)


def op_census(record: Recorder) -> dict[str, int]:
    """Counts of matmuls, kernel-wrapper calls, copies and collectives."""
    return dict(record.calls)
