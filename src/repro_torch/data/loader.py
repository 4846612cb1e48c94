"""Checkpointable data loader with background prefetch.

State is a single integer step counter (the synthetic source is a pure function
of the step), checkpointed alongside the model so restarts resume the stream
exactly.  A daemon thread prefetches ``prefetch`` batches ahead; fetch time is
visible to the timing infrastructure through the PRESTEP bin timer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .synthetic import SyntheticLM

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self, source: SyntheticLM, start_step: int = 0, prefetch: int = 2) -> None:
        self.source = source
        self._step = int(start_step)
        self._prefetch = int(prefetch)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if prefetch > 0:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.source.batch_at(self._step)
            self._step += 1
            return batch
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict[str, int]:
        return {"step": self._step}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # drain so the worker can observe the stop flag
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)

    @classmethod
    def restore(cls, source: SyntheticLM, state: dict[str, int], prefetch: int = 2):
        return cls(source, start_step=int(state["step"]), prefetch=prefetch)
