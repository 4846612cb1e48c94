"""One fleet rank: a real subprocess training worker over the rendezvous store.

``python -m repro_torch.fleet.worker --root DIR --host H`` runs the loop every rank
in a :mod:`repro_torch.fleet.launch` fleet executes:

1. (``--join``) write a ``join/<host>`` request, then wait to be admitted;
2. start the heartbeat thread (``beat/<host>``), the liveness signal;
3. each step: re-read the membership record — refresh the publish epoch, pick
   up the current microbatch ``share`` (this is how a retarget reaches the
   rank), and **discover fencing**: a host absent from the record has been
   evicted and exits cleanly instead of computing into the void;
4. run ``share`` SGD microbatches of the shared least-squares problem, pace to
   ``share x step_floor_s`` (x any injected ``faults/<host>`` slow factor — the
   drill's straggler lever), and publish the measured step walltime stamped
   with the epoch;
5. on the ``shutdown`` key (or ``--max-steps``): write a ``final/<host>``
   result record and exit 0.

Deliberately **numpy-only** — no torch, no repro_torch.dist import — so a rank
spawns in well under a second and a mid-run join costs join-latency, not
compile-latency.  The controller side (which owns the timer DB, detector, and
control loop) lives in :mod:`repro_torch.fleet.launch`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any

import numpy as np

from .store import FileStore
from .transport import FleetTransport

__all__ = ["run_worker"]

#: exit statuses written into the final/<host> record
_STATUS_DONE = "done"  # saw shutdown (or hit --max-steps)
_STATUS_FENCED = "fenced"  # discovered own eviction in the membership record

_MEMBERSHIP_KEY = "membership"


def _make_problem(seed: int, dim: int = 8, n_rows: int = 64):
    """The shared synthetic least-squares problem every rank trains on —
    seeded identically, so any rank's loss trajectory is comparable."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, dim))
    w_true = rng.standard_normal(dim)
    y = x @ w_true + 0.01 * rng.standard_normal(n_rows)
    return x, y


def run_worker(
    root: str,
    host: int,
    *,
    join: bool = False,
    step_floor_s: float = 0.02,
    seed: int = 0,
    heartbeat_interval: float = 0.25,
    poll_interval: float = 0.02,
    max_steps: int = 0,
    admit_timeout_s: float = 30.0,
) -> dict[str, Any]:
    """Run the rank loop; returns the final record also written to the store."""
    store = FileStore(root)
    transport = FleetTransport(
        store, host=host, heartbeat_interval=heartbeat_interval
    )
    transport.start_heartbeat()
    if join:
        store.put(
            f"join/{host}",
            {"host": host, "pid": os.getpid(), "requested": time.time()},
        )

    # -- wait for admission (initial members are already in the record) -------
    deadline = time.monotonic() + admit_timeout_s
    status = _STATUS_DONE
    record = None
    while True:
        if store.get("shutdown") is not None:
            record = None
            break
        record = store.get(_MEMBERSHIP_KEY)
        if record is not None and str(host) in record.get("hosts", {}):
            break
        if time.monotonic() > deadline:
            record = None
            status = "admit_timeout"
            break
        time.sleep(poll_interval)

    x, y = _make_problem(seed)
    w = np.zeros(x.shape[1])
    lr = 0.01
    steps = 0
    loss = float(0.5 * np.mean((x @ w - y) ** 2))

    while record is not None:
        if store.get("shutdown") is not None:
            break
        record = store.get(_MEMBERSHIP_KEY)
        entry = (record or {}).get("hosts", {}).get(str(host))
        if entry is None:
            # fenced out: evicted (or the record vanished) — exit cleanly
            status = _STATUS_FENCED
            break
        transport.epoch = int(record.get("epoch", 0))
        share = max(int(entry.get("share", 1)), 1)
        t0 = time.monotonic()
        for _ in range(share):  # one SGD micro-step per assigned microbatch
            grad = x.T @ (x @ w - y) / len(y)
            w -= lr * grad
        loss = float(0.5 * np.mean((x @ w - y) ** 2))
        # pace the step so walltime tracks assigned work (x injected slowdown)
        fault = store.get(f"faults/{host}") or {}
        factor = max(float(fault.get("slow", 1.0)), 0.0)
        target = step_floor_s * share * (factor if factor > 0 else 1.0)
        elapsed = time.monotonic() - t0
        if elapsed < target:
            time.sleep(target - elapsed)
        transport.publish(host, time.monotonic() - t0)
        steps += 1
        if max_steps and steps >= max_steps:
            break

    transport.stop_heartbeat()
    final = {
        "host": host,
        "status": status,
        "steps": steps,
        "loss": loss,
        "epoch": transport.epoch,
        "pid": os.getpid(),
    }
    store.put(f"final/{host}", final)
    return final


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="rendezvous store directory")
    parser.add_argument("--host", type=int, required=True, help="this rank's host id")
    parser.add_argument(
        "--join",
        action="store_true",
        help="request mid-run admission instead of assuming initial membership",
    )
    parser.add_argument("--step-floor-s", type=float, default=0.02)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--heartbeat-interval", type=float, default=0.25)
    parser.add_argument("--max-steps", type=int, default=0, help="0 = until shutdown")
    args = parser.parse_args(argv)
    final = run_worker(
        args.root,
        args.host,
        join=args.join,
        step_floor_s=args.step_floor_s,
        seed=args.seed,
        heartbeat_interval=args.heartbeat_interval,
        max_steps=args.max_steps,
    )
    return 0 if final["status"] in (_STATUS_DONE, _STATUS_FENCED) else 1


if __name__ == "__main__":
    sys.exit(main())
