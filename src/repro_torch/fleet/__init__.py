"""Fleet coordinates of the port: stage ownership as a pure function of
(membership, stage count) — :mod:`~repro_torch.fleet.topology`.

The rendezvous store, transport, elastic membership, payback gates and the
multi-process launcher come with the fleet slice (ROADMAP Queue 1 item 7).
"""

from .topology import data_parallel_rank, stage_for_host

__all__ = ["data_parallel_rank", "stage_for_host"]
