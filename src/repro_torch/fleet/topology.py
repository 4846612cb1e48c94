"""Mesh/membership coordinate derivations.

The launcher used to hard-code ``stage_for_host={0: 0}``; with a live
membership the mapping must follow the fleet: :func:`stage_for_host` assigns
sorted member hosts to pipeline stages in contiguous blocks — host ``i`` of
``n`` on an ``(S, D)`` pipeline x data mesh owns pipeline coordinate
``i * S // n`` — so stage ownership is a pure function of (membership, stage
count) and re-derives correctly after every join or evict.
"""

from __future__ import annotations

from collections.abc import Iterable

__all__ = ["data_parallel_rank", "stage_for_host"]


def stage_for_host(hosts: Iterable[int], n_stages: int) -> dict[int, int]:
    """{host: owned pipeline stage} — contiguous blocks over sorted hosts.

    Every stage is owned (when ``len(hosts) >= n_stages``) and ownership is
    balanced: ``n`` hosts split into ``n_stages`` runs whose sizes differ by
    at most one.  With fewer hosts than stages, each host owns the first
    stage of its block (the remaining stages ride along in-process, as the
    single-host pipeline path always has).
    """
    ordered = sorted(int(h) for h in hosts)
    if n_stages <= 0 or not ordered:
        return {}
    n = len(ordered)
    return {
        h: min(i * n_stages // n, n_stages - 1) for i, h in enumerate(ordered)
    }


def data_parallel_rank(hosts: Iterable[int], host: int) -> int:
    """``host``'s dense data-parallel coordinate within the sorted membership
    (the index a collective would use, stable under sparse host ids)."""
    ordered = sorted(int(h) for h in hosts)
    try:
        return ordered.index(int(host))
    except ValueError:
        raise ValueError(f"host {host} not in membership {ordered}") from None
