"""``repro_torch.serving`` — the continuous-batching inference engine.

The same surface as ``repro.serving``:

* :class:`ServeSession` — persistent decode batch with per-slot state;
  ``submit()`` returns a :class:`RequestHandle` (``.done`` / ``.result()``),
  ``step()``/``run_until_idle()`` drive the engine, ``stats()`` is the
  engine-level view and ``request_stats()`` / :class:`RequestResult` the
  per-request one.  Construct with ``session=`` (a
  :class:`repro_torch.timing.TimingSession`) so measurements and the serving
  controller land on that session's database and control loop.
* :class:`Request` — the work item (prompt, ``max_new_tokens``, eos).
* :class:`ServiceLevel` — latency/queueing objectives the
  ``ADAPT/serving`` controller enforces.
* :class:`KVCacheManager` — block-based cache accounting (admission bound +
  utilization counters).
"""

from .engine import Request, RequestHandle, RequestResult, ServeSession
from .kvcache import KVCacheManager
from .slo import ServiceLevel

__all__ = [
    "KVCacheManager",
    "Request",
    "RequestHandle",
    "RequestResult",
    "ServeSession",
    "ServiceLevel",
]
