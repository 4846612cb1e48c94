"""The controls of the correctness check, at a cell's own size: the readings
that set each limit's upper end.  Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed, with the weights and inputs a run of that seed uses:

* training cells: the f32 reference's three steps; the same in fp8 (the
  control: the next precision below the configuration's bf16); and, f32,
  each step's loss taken over half of the batch (a fault); each compared
  with the f32 reference by ``compare.train_numbers``.  A step that leaves
  the state unchanged reads 1 on ``delta_gap`` (and ``grad_gap``) by the
  measure itself and needs no run;
* serving cells: the sampled requests' last-position logits in f32 and in
  fp8, and the gap under the f32 logits of the token fp8 puts first.

One JSON line a seed and control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import _setup_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window the serving traffic is drawn for (default: run_seconds)")
    args = ap.parse_args(argv)
    _setup_env()
    import torch

    from portbench import compare, harness, serve_cell
    from portbench.traffic import TrainData, serve_requests
    from portbench.weights import Weights

    spec = harness.load_spec(args.workload)
    ref_mod = harness.reference_module(spec)
    conf, tr, run_ = spec.config, spec.traffic, spec.config["run"]
    seconds = args.seconds or spec.bench["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if tr["kind"] == "train":
            weights = Weights(run_, seed, conf["train_layers"], "cuda")
            batches = [TrainData(tr, run_, seed).batch_at(i) for i in range(3)]
            keep = "grad_diff_median" in spec.load["limits"]
            ref = ref_mod.train_steps(run_, tr, weights, batches, keep_grad=keep)
            for name, kw in (("fp8", {"prec": "fp8"}), ("half_batch", {"half_batch": True})):
                out = ref_mod.train_steps(run_, tr, weights, batches, keep_grad=keep, **kw)
                worst: dict = {}
                numbers = compare.train_numbers(out, ref, worst)
                print(json.dumps({"seed": seed, "control": name, **numbers, "worst": worst}),
                      flush=True)
        else:
            weights = Weights(run_, seed, conf["num_hidden_layers"], "cuda")
            reqs = serve_requests(tr, run_, spec.load["rate_per_s"], seconds, seed)
            prompts = [reqs[j].prompt for j in serve_cell.sample(reqs, spec.load["sample"], seed)]
            ref = ref_mod.prefill_last_logits(run_, weights, prompts)
            low = ref_mod.prefill_last_logits(run_, weights, prompts, prec="fp8")
            tokens = [int(torch.argmax(x)) for x in low]
            print(json.dumps({"seed": seed, "control": "fp8",
                              **compare.serve_numbers(tokens, ref)}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
