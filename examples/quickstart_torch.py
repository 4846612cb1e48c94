"""Quickstart (PyTorch port): the timing infrastructure in 60 lines.

Shows the ``repro_torch.timing`` facade end to end: a session bundling the
timing stack, hierarchical scopes (dynamic and pre-resolved handles),
scope-local counters, a custom clock (the paper's extension mechanism), a
scheduled loop that gets caliper points for free, and both reports — the flat
Fig.-2 table and the scope tree with inclusive/exclusive seconds.  The device
work runs on ``--device`` (the card by default), and every timed scope waits
for the device before it closes, so the timers hold the device's time and not
only the launch.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch import timing  # noqa: E402
from repro_torch.core import CallbackClock, RunState, register_clock  # noqa: E402


def _wait(x: torch.Tensor) -> torch.Tensor:
    """Block until the device has computed ``x`` (``jax.block_until_ready``)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # --- 1. a session: DB + scheduler + control loop, installed as the default ----
    with timing.session() as ts:
        # --- 2. hierarchical scopes (paper Table 3, path-addressed) ---------------
        with timing.scope("poisson"):
            with timing.scope("residual"):              # timer "poisson/residual"
                x = torch.ones((512, 512), device=device)
                _wait(x @ x)
        print("manual scope:", ts.timer("poisson/residual").seconds(), "s\n")

        # hot-loop form: resolve the path once, enter with zero dict lookups
        hot = timing.scope_handle("poisson/hot_loop")

        # --- 3. extensibility: register a custom event clock ----------------------
        _steps = [0.0]
        register_clock(
            "steps",
            lambda: CallbackClock(
                "steps", lambda: {"steps_done": _steps[0]}, {"steps_done": "count"}
            ),
        )

        # counter: resolved once; bumps the process-global xla_flops channel
        bump_flops = timing.counter("xla_flops", absolute=True)

        # --- 4. scheduled loop: every routine gets scoped timers automatically ----
        def evolve(state: RunState) -> None:
            with hot:                                   # nests under EVOL/demo::evolve
                y = torch.sin(torch.arange(4096.0, device=device))
                _wait(y)
            _steps[0] += 1
            bump_flops(4096.0)

        def analysis(state: RunState) -> None:
            time.sleep(0.001)

        ts.scheduler.schedule(evolve, bin="EVOL", thorn="demo")
        ts.scheduler.schedule(analysis, bin="ANALYSIS", thorn="demo", every=2)
        ts.scheduler.run(RunState(max_iterations=6))

        # --- 5. the reports: flat Fig.-2 table + the scope tree --------------------
        print(ts.report(channels=("walltime", "cputime", "xla_flops", "steps_done")))
        print()
        print(ts.tree_report())
        print("\nEVOL rollup (segment-matched):", timing.total_seconds("bin/EVOL"), "s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
