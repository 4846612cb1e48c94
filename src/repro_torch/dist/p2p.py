"""Point-to-point messages between the processes of a pipeline: the 1F1B
rings, the tied table's gradient, a restage's moving units and a
checkpoint's gather.

A :class:`Transport` posts a batch of sends and receives at once (one
``batch_isend_irecv``) and then waits for all of them, so no rank blocks in
a send before its receives are posted.  Its form follows the process
group's backend:

* gloo (ranks that share a card, or run on the host): gloo's ``send`` and
  ``recv`` are documented for host tensors, so a CUDA tensor is staged
  explicitly: copied into a pinned host buffer and sent; received into a
  pinned host buffer and copied onto the card.  The rings reuse their
  buffers (``pooled``); one-off transfers use plain host copies.
* NCCL (a card a rank): the device tensors directly.

Each message adds one to :data:`COUNTS` ``["send"]`` or ``["recv"]`` and its
bytes to :data:`BYTES`.  The time runs inside the timers
``dist/collective/send`` (staging the outgoing messages and posting the
batch) and ``dist/collective/recv`` (waiting for the batch and placing the
incoming messages on the device), as ``dist.collectives`` times the routed
collectives; on CUDA the stream is synchronized first, so the timers hold
the transfers, not the kernels queued before them.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch

__all__ = ["COUNTS", "BYTES", "Transport", "p2p_seconds"]

#: messages of this process, by direction
COUNTS = {"send": 0, "recv": 0}
#: bytes of those messages, by direction
BYTES = {"send": 0, "recv": 0}


def p2p_seconds(db=None) -> dict[str, float]:
    """Seconds in the send and recv timers so far (0 where never entered)."""
    from ..core.timers import timer_db

    db = db if db is not None else timer_db()
    return {k: db.get(f"dist/collective/{k}").seconds()
            if db.exists(f"dist/collective/{k}") else 0.0 for k in COUNTS}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Transport:
    """Batched, counted and timed point-to-point messages of one process
    (module docstring).  ``device`` is where this process's tensors live;
    peers are global ranks of ``group`` (the default group when None)."""

    def __init__(self, device: str | torch.device, group=None) -> None:
        import torch.distributed as dist

        self.device = torch.device(device)
        self.group = group
        self.backend = dist.get_backend(group)
        #: gloo carries host tensors: CUDA messages go through host buffers
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._pool: dict[tuple, torch.Tensor] = {}

    def _host(self, key: tuple | None, shape, dtype) -> torch.Tensor:
        if key is None:  # a one-off transfer: a plain host buffer
            return torch.empty(shape, dtype=dtype)
        n = math.prod(shape)
        buf = self._pool.get(key)
        if buf is None or buf.numel() < n:  # grown, never shrunk: one buffer a message
            buf = self._pool[key] = torch.empty(n, dtype=dtype, pin_memory=True)
        return buf[:n].view(shape)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def exchange(self, sends: Sequence[tuple[int, torch.Tensor, int]],
                 recvs: Sequence[tuple[int, tuple, torch.dtype, int]],
                 pooled: bool = False, on_host: bool = False) -> list[torch.Tensor]:
        """Send every ``(peer, tensor, tag)`` and receive every ``(peer,
        shape, dtype, tag)``, all posted in one batch; returns the received
        tensors on the device (on the host with ``on_host``), in ``recvs``
        order.  Messages between two ranks with one tag arrive in the order
        they were posted.  ``pooled`` keeps pinned staging buffers for the
        next call with the same messages (the rings every tick, the tied
        table every step), each grown to the largest it has carried."""
        import torch.distributed as dist

        from ..timing import scope_handle

        if not sends and not recvs:
            return []
        self._sync()
        ops, outs, host_in = [], [], []
        with scope_handle("dist/collective/send"):
            for k, (peer, tensor, tag) in enumerate(sends):
                tensor = tensor.detach()
                if self.staged:
                    buf = self._host(("send", peer, tag, k, tensor.dtype) if pooled else None,
                                     tensor.shape, tensor.dtype)
                    buf.copy_(tensor, non_blocking=True)
                    tensor = buf
                else:
                    tensor = tensor.contiguous()
                ops.append(dist.P2POp(dist.isend, tensor, peer, self.group, tag))
                COUNTS["send"] += 1
                BYTES["send"] += _nbytes(tensor)
            self._sync()  # the staging copies are in the host buffers
            for k, (peer, shape, dtype, tag) in enumerate(recvs):
                if self.staged:
                    buf = self._host(("recv", peer, tag, k, dtype) if pooled else None,
                                     shape, dtype)
                else:
                    buf = torch.empty(shape, dtype=dtype, device=self.device)
                host_in.append(buf)
                ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
            works = dist.batch_isend_irecv(ops)
        with scope_handle("dist/collective/recv"):
            for work in works:
                work.wait()
            for buf in host_in:
                if on_host:
                    out = buf.clone() if pooled else buf.cpu()
                else:
                    out = buf.to(self.device) if self.staged else buf
                outs.append(out)
                COUNTS["recv"] += 1
                BYTES["recv"] += _nbytes(buf)
            self._sync()
        return outs

    def broadcast(self, tensor: torch.Tensor, src: int) -> torch.Tensor:
        """``src``'s ``tensor`` on every rank (the others pass a tensor of
        the same shape and dtype), on the device; through the host on
        gloo.  Not a point-to-point message: not counted."""
        import torch.distributed as dist

        buf = tensor.detach().cpu().clone() if self.staged else tensor.detach().clone()
        dist.broadcast(buf, src=src, group=self.group)
        return buf.to(self.device)

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``tensor``, on the device (through the host
        on gloo).  Not a point-to-point message: not counted."""
        import torch.distributed as dist

        buf = tensor.detach().cpu().clone() if self.staged else tensor.detach().clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(self.device)
