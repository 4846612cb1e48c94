"""Block-based KV-cache accounting for the continuous-batching engine.

The persistent decode cache is allocated dense (``n_slots`` slots of
``max_seq`` positions — the layout :func:`repro.models.model.init_cache`
produces), but admission reasons about it in fixed-size **blocks**, the unit
production engines page in (vLLM-style): a request reserves
``ceil(tokens / block_size)`` blocks at admission and frees them on
completion, so "is there cache room?" is a pool arithmetic question and the
shed/admit decisions on the control plane see one number — block utilization —
regardless of model family.

The per-request token footprint is family-aware:

* **global attention** (``attn`` / ``xattn`` blocks): K/V grow with the
  sequence, so a request costs ``prompt + max_new`` token positions (capped at
  ``max_seq``);
* **windowed attention only** (``attn_local``): the ring buffer bounds the
  footprint at ``window`` positions however long the request runs;
* **pure recurrent** (``rglru`` / ``rwkv``): state is O(1) per request — one
  block, the "recurrent-state slot".

Block mapping is slot-contiguous (slot ``i``, block ``j`` covers positions
``[j*block_size, (j+1)*block_size)`` of that slot), so reservations never
fragment; what the manager adds over raw slot counting is the *token-level*
admission bound and the utilization counters (``serve/kv_alloc_blocks`` /
``serve/kv_freed_blocks`` via :func:`repro.timing.counter`) that the
:class:`~repro.adapt.serving.ServingControl` and the reports read.
"""

from __future__ import annotations

import math

from ..core.timers import TimerDB
from ..models.config import ArchConfig
from ..models.model import decoder_pattern

__all__ = ["KVCacheManager"]


def _effective_seq(cfg: ArchConfig, max_seq: int) -> int:
    """Token positions one request can occupy in the cache: ``max_seq`` for
    global attention, the window for window-only stacks, 0 (constant state)
    for pure recurrent families."""
    kinds = set(decoder_pattern(cfg))
    if kinds & {"attn", "xattn"}:
        return max_seq
    if "attn_local" in kinds:
        return min(cfg.window or max_seq, max_seq)
    return 0


class KVCacheManager:
    """Alloc/free block accounting over one dense ``n_slots x max_seq`` cache.

    Parameters
    ----------
    cfg:
        Model config; decides the family footprint rule (see module doc).
    n_slots / max_seq:
        Geometry of the persistent decode cache being accounted for.
    block_size:
        Tokens per block (power-of-two sizes round-trip best, but any
        positive size works).
    db:
        Timer database whose counter channels receive the alloc/free totals
        (process default when ``None``).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        n_slots: int,
        max_seq: int,
        block_size: int = 16,
        db: TimerDB | None = None,
    ) -> None:
        if n_slots < 1 or max_seq < 1 or block_size < 1:
            raise ValueError("n_slots, max_seq and block_size must be >= 1")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self._eff_seq = _effective_seq(cfg, max_seq)
        #: blocks one fully-loaded request can reserve (>= 1 even for the
        #: recurrent families, whose state occupies one block per request)
        self.blocks_per_slot = max(1, math.ceil(self._eff_seq / block_size))
        self.total_blocks = n_slots * self.blocks_per_slot
        self._reserved: dict[int, int] = {}
        self._high_water = 0
        from ..timing.scopes import counter

        self._c_alloc = counter("serve/kv_alloc_blocks", db=db)
        self._c_freed = counter("serve/kv_freed_blocks", db=db)

    # -- sizing -----------------------------------------------------------------
    def blocks_for(self, total_tokens: int) -> int:
        """Blocks a request spanning ``total_tokens`` positions reserves."""
        if total_tokens < 0:
            raise ValueError(f"negative token count {total_tokens}")
        tokens = min(total_tokens, self._eff_seq)
        return max(1, math.ceil(tokens / self.block_size))

    # -- pool state -------------------------------------------------------------
    @property
    def reserved_blocks(self) -> int:
        return sum(self._reserved.values())

    @property
    def free_blocks(self) -> int:
        return self.total_blocks - self.reserved_blocks

    @property
    def high_water(self) -> int:
        """Peak reserved blocks over the manager's lifetime."""
        return self._high_water

    def utilization(self) -> float:
        """Reserved fraction of the pool, 0..1."""
        return self.reserved_blocks / self.total_blocks

    # -- alloc / free -----------------------------------------------------------
    def can_admit(self, total_tokens: int) -> bool:
        return self.blocks_for(total_tokens) <= self.free_blocks

    def allocate(self, rid: int, total_tokens: int) -> int:
        """Reserve blocks for request ``rid``; returns the count reserved.

        Reservation happens once, at admission, for the request's worst case
        (prompt + max new tokens), so decode can never run out of cache
        mid-stream — admission control is where "full" is decided.
        """
        if rid in self._reserved:
            raise ValueError(f"request {rid} already holds blocks")
        need = self.blocks_for(total_tokens)
        if need > self.free_blocks:
            raise ValueError(
                f"request {rid} needs {need} blocks, only {self.free_blocks} free"
            )
        self._reserved[rid] = need
        self._high_water = max(self._high_water, self.reserved_blocks)
        self._c_alloc(need)
        return need

    def free(self, rid: int) -> int:
        """Release request ``rid``'s blocks; returns the count released."""
        freed = self._reserved.pop(rid, 0)
        if freed:
            self._c_freed(freed)
        return freed

    def stats(self) -> dict[str, float]:
        return {
            "total_blocks": float(self.total_blocks),
            "reserved_blocks": float(self.reserved_blocks),
            "free_blocks": float(self.free_blocks),
            "high_water_blocks": float(self._high_water),
            "utilization": self.utilization(),
            "block_size": float(self.block_size),
        }
