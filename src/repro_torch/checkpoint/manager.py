"""Checkpoint manager: async writes, retention, emergency save, resume planning.

Timing integration (the paper's subject): ``save`` splits into a *blocking*
phase — device→host snapshot + submission, the part that steals wall time from
compute and is what AdaptCheck bounds — and an *async* phase on a writer
thread.  The snapshot copies every tensor leaf to the host, CPU tensors too:
the optimizer updates its state in place, and a writer reading the live
tensors would race the next step.  A CUDA leaf's copy is synchronous, so the
blocking seconds hold the whole device→host transfer.  The blocking seconds
and written bytes are reported to the caller and
pushed onto the ``io`` counter channels so every timer window can see I/O
traffic.  ``synchronous=True`` reproduces the paper's blocking checkpointing
(used as the paper-faithful baseline in benchmarks).

Fault tolerance is structural, not best-effort:

* restores go through a :class:`~repro_torch.checkpoint.resume.ResumePlan` — every
  on-disk checkpoint is validated (load-free streamed hashing), corrupt ones
  are quarantined into ``corrupt/`` with a reason file and counted, and the
  newest valid one is selected (latest-valid with last-known-good fallback);
* retention is a :class:`~repro_torch.checkpoint.retention.RetentionPolicy`
  (``keep_last_n`` + ``keep_every_k``) whose GC can **never** delete the
  newest valid checkpoint, even when every newer directory is corrupt;
* directory mutations (write, GC, quarantine, scan) serialize on one
  filesystem lock, so the async writer's GC cannot race a concurrent
  ``checkpoints()`` / ``restore_latest`` on the caller thread;
* :meth:`install_sigterm_handler` performs a *deadline-bounded* emergency
  save (preemption notice → durable checkpoint before the platform's grace
  period expires) and chains any previously installed handler instead of
  clobbering it.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections.abc import Callable
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any

import numpy as np
import torch

from ..models.layers import tree_map
from ..timing import counter
from .io import checkpoint_nbytes, load_checkpoint, save_checkpoint
from .resume import ResumePlan, list_quarantined, plan_resume, quarantine_checkpoint, scan_checkpoints
from .retention import RetentionPolicy

# channel cells resolved once through the timing facade (lock-free C-level
# increment on the write path); absolute: the `io` CounterClock exports them
_BUMP_IO_BYTES = counter("io_bytes", absolute=True)
_BUMP_IO_OPS = counter("io_ops", absolute=True)

__all__ = ["CheckpointManager"]


def _host_copy(leaf):
    """A host copy no later in-place update can reach (scalars pass through)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def snapshot(tree: Any) -> Any:
    """The tree with every tensor and array leaf copied to the host."""
    return tree_map(_host_copy, tree)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep_n: int = 3,
        synchronous: bool = False,
        fsync: bool = False,
        delay_s: float = 0.0,
        delay_s_per_mb: float = 0.0,
        keep_every_k: int = 0,
        retention: RetentionPolicy | None = None,
    ) -> None:
        """``delay_s`` (+ ``delay_s_per_mb`` × payload) injects artificial write
        latency (experiments: emulate a slow/contended filesystem and
        size-proportional write cost, as in the paper's AMR scenario where
        checkpoint data grows O(L)).  ``retention`` overrides the
        ``keep_n``/``keep_every_k`` sugar with an explicit policy."""
        self.directory = directory
        self.retention = (
            retention
            if retention is not None
            else RetentionPolicy(keep_last_n=keep_n, keep_every_k=keep_every_k)
        )
        self.synchronous = synchronous
        self.fsync = fsync
        self.delay_s = delay_s
        self.delay_s_per_mb = delay_s_per_mb
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: Future | None = None
        #: guards manager state: _pending and the save statistics
        self._lock = threading.Lock()
        #: guards directory mutations/listings: the async writer runs GC while
        #: the caller thread may be scanning (checkpoints / restore_latest)
        self._fs_lock = threading.Lock()
        self.n_saves = 0
        self.total_blocking_seconds = 0.0
        self.total_bytes = 0
        self.last_resume_plan: ResumePlan | None = None

    @property
    def keep_n(self) -> int:  # back-compat alias for the retention knob
        return self.retention.keep_last_n

    # -- save ------------------------------------------------------------------
    def _write(self, step: int, host_tree, metadata) -> tuple[str, int]:
        if self.delay_s or self.delay_s_per_mb:
            nbytes = checkpoint_nbytes(host_tree)
            time.sleep(self.delay_s + self.delay_s_per_mb * nbytes / 1e6)
        with self._fs_lock:
            path, nbytes = save_checkpoint(
                self.directory, step, host_tree, metadata, fsync=self.fsync
            )
        _BUMP_IO_BYTES(float(nbytes))
        _BUMP_IO_OPS(1.0)
        self.gc()
        return path, nbytes

    def save(
        self, step: int, tree: Any, metadata: dict[str, Any] | None = None
    ) -> dict[str, float]:
        """Snapshot + write. Returns stats incl. blocking seconds and bytes."""
        t0 = time.monotonic()
        self.wait()  # never queue more than one outstanding write
        host_tree = snapshot(tree)
        nbytes = checkpoint_nbytes(host_tree)
        if self.synchronous:
            self._write(step, host_tree, metadata)
            blocking = time.monotonic() - t0
        else:
            future = self._pool.submit(self._write, step, host_tree, metadata)
            blocking = time.monotonic() - t0
            with self._lock:
                self._pending = future
        with self._lock:
            self.n_saves += 1
            self.total_blocking_seconds += blocking
            self.total_bytes += nbytes
        return {"blocking_seconds": blocking, "nbytes": float(nbytes), "step": float(step)}

    def wait(self, timeout: float | None = None) -> None:
        """Block until the outstanding async write (if any) is durable."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending.result(timeout=timeout)
            except (_FuturesTimeout, TimeoutError) as exc:
                # (futures.TimeoutError is a distinct class before 3.11)
                # still in flight: put it back so a later wait can finish it
                with self._lock:
                    if self._pending is None:
                        self._pending = pending
                raise TimeoutError(str(exc) or "checkpoint write still in flight") from exc

    # -- restore ---------------------------------------------------------------
    def checkpoints(self) -> list[tuple[int, str]]:
        """Committed checkpoint directories (no validation), oldest first."""
        with self._fs_lock:
            records = scan_checkpoints(self.directory, validate=False)
        return sorted((r.step, r.path) for r in records if r.status == "valid")

    def resume_plan(self, quarantine: bool = True) -> ResumePlan:
        """Scan + validate + quarantine; the full resume picture without
        loading anything.  Stored on :attr:`last_resume_plan`."""
        with self._fs_lock:
            plan = plan_resume(self.directory, quarantine=quarantine)
        self.last_resume_plan = plan
        return plan

    def restore_latest(
        self, device: str | torch.device | None = None
    ) -> tuple[int, Any, dict[str, Any]] | None:
        """Load the newest valid checkpoint per the :class:`ResumePlan`, its
        leaves as tensors on ``device`` (the host when ``None``).

        Corrupt directories are quarantined with a reason file and counted
        (``ckpt_validation_failures``) — never silently skipped.  If the
        selected checkpoint fails *at load* (validation/load race, e.g.
        storage going bad underneath us), it is quarantined too and the plan's
        next valid record — the last known good — is tried.
        """
        plan = self.resume_plan(quarantine=True)
        for record in plan.valid:
            try:
                # validation already streamed the hashes; load without re-hashing
                return load_checkpoint(record.path, device=device, verify=False)
            except Exception as exc:  # noqa: BLE001 - quarantine, then fall back
                with self._fs_lock:
                    if os.path.isdir(record.path):
                        quarantine_checkpoint(
                            record.path, f"load_failed: {exc}", root=self.directory
                        )
                plan.quarantined.append(record)
                continue
        return None

    def quarantined(self) -> list[dict[str, str]]:
        """Entries under ``corrupt/`` with their recorded reasons."""
        with self._fs_lock:
            return list_quarantined(self.directory)

    # -- retention -----------------------------------------------------------------
    def gc(self) -> list[int]:
        """Apply the retention policy; returns the steps actually deleted.

        Safety invariant (not policy-tunable): the newest checkpoint that
        passes validation is never deleted, even when ``keep_last_n`` newer —
        but corrupt — directories would otherwise crowd it out.
        """
        import shutil

        from .io import CheckpointCorrupt, validate_checkpoint

        with self._fs_lock:
            records = scan_checkpoints(self.directory, validate=False)
            by_step = {r.step: r.path for r in records if r.status == "valid"}
            doomed = self.retention.doomed(list(by_step))
            if doomed:
                # find the newest directory that actually validates; it is
                # exempt from deletion no matter what the policy says
                newest_valid: int | None = None
                for step in sorted(by_step, reverse=True):
                    try:
                        validate_checkpoint(by_step[step])
                    except CheckpointCorrupt:
                        continue
                    newest_valid = step
                    break
                doomed = [s for s in doomed if s != newest_valid]
            for step in doomed:
                shutil.rmtree(by_step[step], ignore_errors=True)
        return doomed

    # -- fault hooks -----------------------------------------------------------------
    def install_sigterm_handler(
        self,
        state_fn: Callable[[], tuple[int, Any]],
        deadline_s: float | None = None,
    ) -> Callable:
        """Emergency checkpoint on SIGTERM (pre-emption / queue kill).

        ``deadline_s`` is the platform's grace period (spot reclaim, SLURM
        grace, renewable-power window): the handler spends at most that long
        making the save durable — any in-flight async write gets the remaining
        budget to finish, the emergency write itself is synchronous, and the
        artificial experiment delays are skipped (a preemption save must never
        sleep on purpose).  Whether the deadline was met is recorded in the
        checkpoint metadata.

        Any previously installed SIGTERM handler is **chained** (invoked after
        the save), not clobbered — launchers and test harnesses keep their
        shutdown hooks.  Returns the installed handler (tests).
        """
        previous = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):  # pragma: no cover - exercised via subprocess
            t0 = time.monotonic()
            step, tree = state_fn()
            try:
                budget = None if deadline_s is None else max(
                    deadline_s - (time.monotonic() - t0), 0.01
                )
                self.wait(timeout=budget)
            except TimeoutError:
                pass  # pending write keeps running; the emergency save proceeds
            host_tree = snapshot(tree)
            delay_s, delay_mb = self.delay_s, self.delay_s_per_mb
            self.delay_s = self.delay_s_per_mb = 0.0
            try:
                elapsed = time.monotonic() - t0
                self._write(
                    step,
                    host_tree,
                    {
                        "emergency": True,
                        "deadline_s": deadline_s,
                        "met_deadline": (
                            True if deadline_s is None else elapsed < deadline_s
                        ),
                    },
                )
            finally:
                self.delay_s, self.delay_s_per_mb = delay_s, delay_mb
            if callable(previous):
                previous(signum, frame)
            elif previous == signal.SIG_DFL:
                # restore + re-raise so the default termination still happens
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, handler)
        return handler

    # -- monitoring -------------------------------------------------------------------
    def status_payload(self) -> dict[str, Any]:
        """JSON-ready view for the monitor's ``/checkpoints`` endpoint."""
        with self._lock:
            totals = {
                "n_saves": self.n_saves,
                "total_bytes": self.total_bytes,
                "total_blocking_seconds": self.total_blocking_seconds,
            }
        return {
            "directory": self.directory,
            "retention": self.retention.summary(),
            "checkpoints": [
                {"step": step, "path": path} for step, path in self.checkpoints()
            ],
            "quarantined": self.quarantined(),
            "resume": (
                self.last_resume_plan.summary() if self.last_resume_plan else None
            ),
            "totals": totals,
        }

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
