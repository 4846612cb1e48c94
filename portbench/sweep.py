"""Find a serving cell's knee: the highest offered rate the engine sustains
without a growing backlog.  Not part of a benchmark run; the cell's
``rate_per_s``, written into the cell's file, is at most 0.8 of the knee it
finds, and low enough that a traced run (slower by the profiler's cost a
launch) keeps up.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds 30 --rates 4,5,6,7

One engine is set up, then each rate's open loop runs for ``--seconds``
(the traffic of the cell's file at that rate, a seed of its own).  A line a
rate: requests offered and answered, time to first token (median, p95) and
queue wait (p95) from the due time, the p95 of the first and the second
half of the arrivals, the seconds the backlog took to drain after the last
arrival, and the share of the window the ``serve/prefill`` scope was busy.
A rate is sustained when the second half's p95 is not far above the
first's and the drain is a few prefills long.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from run import _setup_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    _setup_env()
    from portbench import harness, serve_cell
    from portbench.traffic import serve_requests
    from repro_torch.serving import Request

    spec = harness.load_spec(args.workload)
    engine, sess, _ = serve_cell.make_engine(spec, args.seed, "cuda", time.perf_counter())
    tr = spec.traffic
    prefill = sess.db.get("serve/prefill")
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = serve_requests(tr, spec.config["run"], rate, args.seconds, args.seed + 1 + k)
        p0 = prefill.seconds()
        t0 = time.monotonic()
        handles, late = serve_cell.open_loop(engine, Request, reqs, args.seconds,
                                             tr["max_new_tokens"], t0)
        t1 = time.monotonic()
        done, ttft = serve_cell.answered(reqs, handles, t0, t1)
        wait = [res.admitted_at - (t0 + r.due) for r, res in done]
        half = len(ttft) // 2
        row = {
            "rate": rate, "offered": len(reqs), "answered": len(done),
            "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
            "ttft_p95_first_half_ms": 1e3 * float(np.percentile(ttft[:half], 95)),
            "ttft_p95_second_half_ms": 1e3 * float(np.percentile(ttft[half:], 95)),
            "queue_wait_p95_ms": 1e3 * float(np.percentile(wait, 95)),
            "drain_s": t1 - t0 - reqs[-1].due, "generator_late_s": late,
            "prefill_busy_share": (prefill.seconds() - p0) / (t1 - t0),
            "mean_prefill_ms": 1e3 * (prefill.seconds() - p0) / max(len(done), 1),
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
