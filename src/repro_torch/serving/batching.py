"""Slot state and cache splicing — the in-flight half of continuous batching.

The engine keeps ONE persistent decode cache of ``n_slots`` batch rows and
never re-batches it: a newly admitted request is prefilled alone (exact, no
cross-request padding) into a single-row cache and **spliced** into a free
slot, while every other slot keeps decoding.  Splicing writes the fresh row
into the persistent cache **in place**: for each leaf, the batch axis (located
by the leaf's logical axes from :func:`repro_torch.models.model.cache_axes`)
is moved to the front of a view and row ``slot`` of that view is overwritten.

Heterogeneous progress needs no masking machinery: the decode cache carries a
per-row ``pos`` (see :func:`repro_torch.models.model.decode_step`), so slots
prefilled at different times simply decode at different positions in the same
lock-step call.  Free slots decode garbage that is never read; their cache
rows are fully overwritten by the next splice.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

from ..models import model as M
from ..models.config import ArchConfig
from ..models.layers import tree_map

__all__ = ["Slot", "make_cache_splicer", "slot_stats"]


def make_cache_splicer(
    cfg: ArchConfig, n_slots: int, max_seq: int
) -> Callable[[Any, Any, int], Any]:
    """Build ``splice(dst_cache, src_cache, slot) -> dst_cache``.

    ``dst_cache`` is the persistent ``n_slots``-row cache, ``src_cache`` a
    freshly prefilled single-row cache of the same ``max_seq``; ``slot`` the
    destination row index.  ``dst_cache`` is updated in place and returned.
    """
    axes = M.cache_axes(cfg, n_slots, max_seq)

    def _splice(dst, src, slot: int):
        def put(d, s, ax):
            b = ax.index("batch")
            d.movedim(b, 0)[slot] = s.movedim(b, 0)[0]

        tree_map(put, dst, src, axes)
        return dst

    return _splice


@dataclass
class Slot:
    """One row of the persistent decode batch.

    A slot is *free* when ``request is None``; admission binds a request (and
    its result-in-progress) to the slot, completion unbinds it.  ``generated``
    counts emitted tokens (the prefill token included), so
    ``generated == request.max_new_tokens`` is the length stop.
    """

    index: int
    request: Any | None = None
    handle: Any | None = None
    generated: int = 0
    blocks: int = 0

    @property
    def free(self) -> bool:
        return self.request is None

    def bind(self, request, handle, blocks: int) -> None:
        self.request = request
        self.handle = handle
        self.generated = 0
        self.blocks = blocks

    def release(self) -> None:
        self.request = None
        self.handle = None
        self.generated = 0
        self.blocks = 0


@dataclass
class SlotStats:
    """Aggregate view over the slot array (engine-level ``stats()`` rows)."""

    n_slots: int
    active: int
    free: int
    occupancy: float = field(init=False)

    def __post_init__(self) -> None:
        self.occupancy = self.active / self.n_slots if self.n_slots else 0.0


def slot_stats(slots: list[Slot]) -> SlotStats:
    active = sum(1 for s in slots if not s.free)
    return SlotStats(n_slots=len(slots), active=active, free=len(slots) - active)
