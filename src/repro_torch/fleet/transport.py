"""Cross-process step-time transport over the rendezvous store.

:class:`FleetTransport` implements the exact two-call surface the straggler
reduction already consumes (:class:`repro_torch.dist.stragglers.LocalTransport`:
``publish`` / ``gather`` / ``drop_host`` / ``dropped``) — so the detector, the
response policy, and every test built on the in-process transport work
unchanged when the samples start arriving from real subprocess ranks.

Wire format: worker rank ``h`` appends ``{"e": epoch, "s": seconds}`` records
to the ``samples/h`` log; the controller side drains each log from a tracked
byte offset.  Two defenses make a partitioned or killed rank *detected* rather
than assumed:

* **epoch fencing** — every sample carries the membership epoch the worker
  believed current when it published.  The gather side rejects records from
  hosts outside the current membership and records stamped before the host's
  admission epoch (a stale incarnation of a reused id); every rejection counts
  in :attr:`FleetTransport.stale_rejected`.  A fenced-out rank can keep
  writing — its bytes land, its samples never reach the reduction.
* **heartbeats + liveness** — each worker runs a daemon heartbeat thread
  (:meth:`start_heartbeat`) refreshing ``beat/h``; the membership layer evicts
  hosts whose beat age exceeds the liveness timeout.  A SIGSTOP'd rank stops
  beating and is fenced the same as a SIGKILL'd one.
"""

from __future__ import annotations

import os
import threading
import time

from .store import FileStore

__all__ = ["FleetTransport"]


class FleetTransport:
    """File-store-backed ``publish``/``gather`` transport with epoch fencing.

    One class serves both sides.  A worker constructs it with its ``host`` id
    and calls :meth:`publish` (stamping :attr:`epoch`, which the worker
    refreshes from the membership record each step) plus
    :meth:`start_heartbeat`.  The controller constructs it with a
    ``members_fn`` — ``() -> (epoch, {host: joined_epoch})`` from the live
    :class:`~repro_torch.fleet.membership.Membership` — and hands it to the
    :class:`~repro_torch.dist.stragglers.StragglerDetector` as its transport.
    """

    def __init__(
        self,
        store: FileStore,
        *,
        host: int | None = None,
        members_fn=None,
        heartbeat_interval: float = 0.5,
    ) -> None:
        self.store = store
        self.host = host
        self.members_fn = members_fn
        self.heartbeat_interval = heartbeat_interval
        #: worker side: the membership epoch stamped on the next publish
        self.epoch = 0
        #: controller side: samples rejected by the epoch fence
        self.stale_rejected = 0
        self._offsets: dict[int, int] = {}
        self._dropped: set[int] = set()
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None

    # -- worker side ------------------------------------------------------------
    def publish(self, host: int, seconds: float) -> None:
        """Append one step walltime, stamped with the current :attr:`epoch`."""
        self.store.append(
            f"samples/{int(host)}", {"e": int(self.epoch), "s": float(seconds)}
        )

    def heartbeat(self, host: int | None = None) -> None:
        h = self.host if host is None else host
        self.store.put(f"beat/{int(h)}", {"t": time.time(), "pid": os.getpid()})

    def start_heartbeat(self, host: int | None = None) -> None:
        """Run :meth:`heartbeat` on a daemon thread every interval.  A stopped
        (SIGSTOP) process stops the thread with it — exactly the liveness
        signal the membership layer needs."""
        if self._hb_thread is not None:
            return
        h = self.host if host is None else host
        stop = threading.Event()

        def beat() -> None:
            while not stop.is_set():
                try:
                    self.heartbeat(h)
                except OSError:
                    pass  # rendezvous dir tearing down at shutdown
                stop.wait(self.heartbeat_interval)

        self._hb_stop = stop
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=2.0)
            self._hb_stop = None
            self._hb_thread = None

    # -- controller side --------------------------------------------------------
    def _fence(self) -> tuple[int, dict[int, int]]:
        if self.members_fn is None:
            return self.epoch, {}
        epoch, joined = self.members_fn()
        return int(epoch), {int(h): int(e) for h, e in joined.items()}

    def gather(self) -> dict[int, list[float]]:
        """Drain every sample log past its offset; fence, then deliver.

        A sample survives the fence iff its host is in the *current*
        membership, has not been dropped, and the stamped epoch is at or
        after the host's admission epoch.  Everything else increments
        :attr:`stale_rejected` — the partitioned-rank detection signal.
        """
        epoch, joined = self._fence()
        out: dict[int, list[float]] = {}
        for log in self.store.logs("samples"):
            try:
                host = int(log.rsplit("/", 1)[1])
            except ValueError:
                continue
            records, self._offsets[host] = self.store.read_log(
                log, self._offsets.get(host, 0)
            )
            for rec in records:
                stamped = int(rec.get("e", -1))
                if (
                    host in self._dropped
                    or (self.members_fn is not None and host not in joined)
                    or (self.members_fn is not None and stamped < joined.get(host, 0))
                ):
                    self.stale_rejected += 1
                    continue
                out.setdefault(host, []).append(float(rec.get("s", 0.0)))
        return out

    def drop_host(self, host: int) -> None:
        """Stop accepting samples from ``host`` (eviction path)."""
        self._dropped.add(int(host))

    @property
    def dropped(self) -> frozenset:
        return frozenset(self._dropped)
