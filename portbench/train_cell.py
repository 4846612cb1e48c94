"""Training cells: the program's ``run_training`` (``launch/train.py``), its
scheduler, timer tree and control loop, driven through one run.

The benchmark joins the run as a thorn of the program's own scheduler:

* STARTUP, after the launcher's own startup routine: the benchmark's weights go into the
  program's parameters and f32 master copy (in place), and the benchmark's
  batches replace the program's data loader;
* steps 1-3 (``CHECKED``) are set-up: they warm up every shape, and their
  batches as each step took them (a digest of each, read on the device),
  their losses, the first step's gradient (from the optimizer's first moment,
  m / ((1 - b1) * clip scale); its norms, and where the cell's limits name
  ``grad_diff_median`` a host copy of it outside the expert stacks) and the parameters' change after
  the third step (from the f32 master copy) are read for the check;
* PRESTEP of step 4 opens the window; OUTPUT of the first step that ends
  ``--seconds`` or more after it closes the window and ends the run.

After the run the state is freed and the reference trains the same three
steps from the same weights and the benchmark's own batches, drawn again
from the seed; ``batch_mismatch`` (limit 0) counts the checked steps whose
batch, as the step took it, differs from the one the reference trains on.
"""

from __future__ import annotations

import gc
import hashlib
import math
import time

from . import compare, harness, program, work
from .traffic import TrainData
from .weights import Weights

__all__ = ["CHECKED", "run", "digest"]

CHECKED = 3


def digest(batch: dict) -> str:
    """A batch's digest: its arrays' names, types, shapes and bytes (numpy
    arrays, or tensors anywhere)."""
    h = hashlib.sha256()
    for key in sorted(batch):
        x = batch[key]
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
        h.update(f"{key}:{x.dtype}:{x.shape};".encode())
        h.update(x.tobytes())
    return h.hexdigest()[:16]


def run(spec, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    import torch

    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.timing import TimingSession

    from .trace import Tracer

    conf, tr = spec.config, spec.traffic
    layers = conf["train_layers"]
    cfg = program.arch_config(conf, layers)
    weights = Weights(conf["run"], seed, layers, device)
    data = TrainData(tr, conf["run"], seed)
    ref_mod = harness.reference_module(spec)
    sched = tr["schedule"]
    settings = TrainSettings(
        arch=conf["name"], smoke=False, steps=10**9, global_batch=tr["batch"],
        seq_len=tr["text_len"], peak_lr=sched["peak_lr"], lr_total_steps=sched["total_steps"],
        ckpt_mode="off", report_every=0, data_mode="random", seed=0, device=device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tracer = Tracer() if trace else None
    st: dict = {"loss": [], "bad": 0, "took": []}
    sess = TimingSession()
    sch = sess.scheduler

    def load(s):
        harness.log(t_start, "program started")
        program.fill_train_state(s["params"], s["opt_state"], cfg, weights)
        s["loader"].close()
        s["loader"] = data

    def observe(s):
        i, m = s.iteration, s["metrics"]
        if i < CHECKED:
            st["loss"].append(m["loss"])
            st["took"].append(digest(s["batch"]))
            harness.log(t_start, f"checked step {i + 1} done")
        elif not math.isfinite(m["loss"]):
            st["bad"] += 1
        if i == 0:
            clip = m.get("clip_scale", min(1.0, tr["optimizer"]["clip_norm"]
                                           / max(m["grad_norm"], 1e-12)))
            scale = 1.0 / ((1.0 - tr["optimizer"]["b1"]) * clip)
            st["grad"] = program.leaf_norms(s["opt_state"]["m"], cfg, scale=scale)
            if "grad_diff_median" in spec.load["limits"]:
                st["grad_full"] = program.leaf_copies(s["opt_state"]["m"], cfg, scale=scale,
                                                      skip=ref_mod.is_expert_stack)
        if i == CHECKED - 1:
            state = s["opt_state"].get("master", s["params"])
            st["delta"] = program.leaf_norms(state, cfg, minus=weights)

    def mark(s):
        sync()
        st["setup_s"] = time.perf_counter() - t_start
        st["opened"] = program.timer_record(sess.db)
        if tracer is not None:
            tracer.start()
        st["t0"] = time.perf_counter()

    def close(s):
        if s.iteration < CHECKED or time.perf_counter() - st["t0"] < seconds:
            return
        sync()
        st["t1"] = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        st["steps"] = s.iteration - CHECKED + 1
        st["closed"] = program.timer_record(sess.db)
        s.should_terminate = True

    sch.schedule(load, bin="STARTUP", thorn="portbench", after=("driver::startup",))
    sch.schedule(observe, bin="ANALYSIS", thorn="portbench")
    sch.schedule(mark, bin="PRESTEP", thorn="portbench", before=("data::fetch_data",),
                 when=lambda s: s.iteration == CHECKED)
    sch.schedule(close, bin="OUTPUT", thorn="portbench", after=("report::output",))
    summary = run_training(settings, cfg=cfg, session=sess)
    harness.log(t_start, f"window closed: {st['steps']} steps in {st['t1'] - st['t0']:.3f} s "
                f"(set-up {st['setup_s']:.3f} s)")
    if summary["iterations"] != CHECKED + st.get("steps", -10**9):
        raise RuntimeError(f"the run stopped at step {summary['iterations']}, not at the "
                           f"window's close")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del summary, sess, sch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    window_s = st["t1"] - st["t0"]
    flops = work.train_step_flops(conf["run"], tr["batch"], tr["text_len"], layers)
    n = conf["run"].get("n_vision_patches", 0) + tr["text_len"]
    spans, counters = harness.window_record(st["opened"], st["closed"])
    ctx = harness.Context(spec, window_s, trace=tracer.trace() if tracer else None, values={
        "steps": st["steps"],
        "flops_per_step": flops["total"], "positions_per_step": flops["positions"],
        "attn_fwd_per_step": work.attention_fwd(conf["run"], tr["batch"], n, layers),
        "attn_bwd_per_step": work.attention_bwd(conf["run"], tr["batch"], n, layers),
    }, spans=spans, counters=counters)
    e2e = {"train_tokens_per_s": st["steps"] * flops["positions"] / window_s,
           "setup_s": st["setup_s"]}

    batches = [data.batch_at(i) for i in range(CHECKED)]
    drawn = [digest(b) for b in batches]
    harness.log(t_start, f"checked steps' batches: taken {st['took']}, drawn again {drawn}")
    ref = ref_mod.train_steps(conf["run"], tr, weights, batches, keep_grad="grad_full" in st)
    worst: dict = {}
    numbers = compare.train_numbers(st, ref, worst)
    harness.log(t_start, f"reference done; numbers {numbers}, worst leaves {worst}")
    checks = {k: (numbers[k], lim) for k, lim in spec.load["limits"].items()}
    checks["batch_mismatch"] = (float(sum(a != b for a, b in zip(st["took"], drawn, strict=True))),
                                0.0)
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "attempted": st["steps"],
            "failed": st["bad"], "memory_peak": peak}
