"""Serving cells: the program's continuous-batching engine
(``serving/engine.py`` ``ServeSession`` with its ``ADAPT/serving`` control,
best-effort service level) under an open loop.

Set-up builds the kernels, puts the benchmark's weights into a parameter
tree, starts the engine and serves one request at the shortest and one at
the longest prompt length of the mix.  The window then offers the traffic
file's requests at the cell's rate: each is submitted when it comes due,
and the engine steps while it has work.  A request's time to first token
and its queue wait count from when it was due.  The window closes when
every request due in it has its answer, or a minute past its last arrival.

After the window the engine and weights are freed, and the reference
computes the last-position logits of a sample of the window's requests (the
longest among them, the rest drawn from the seed) layer by layer.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from . import compare, harness, program, work
from .traffic import serve_requests
from .weights import Weights

__all__ = ["run", "make_engine", "open_loop", "answered", "sample", "DRAIN_S"]

DRAIN_S = 60.0


def _p95(values: list[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def open_loop(engine, request_cls, reqs, seconds: float, max_new: int, t0: float):
    """Offer ``reqs`` to ``engine`` as they come due (``due`` seconds after
    ``t0``, monotonic clock), stepping the engine while it has work, until
    every request is answered or ``DRAIN_S`` past ``seconds``.  Returns the
    handles in order of arrival and how late the generator ran at worst."""
    handles, late, i = [], 0.0, 0
    while True:
        now = time.monotonic() - t0
        while i < len(reqs) and reqs[i].due <= now:
            late = max(late, now - reqs[i].due)
            handles.append(engine.submit(request_cls(reqs[i].index, list(reqs[i].prompt),
                                                     max_new_tokens=max_new)))
            i += 1
        if engine.queue_depth or engine.active_slots:
            engine.step()
        elif i < len(reqs):
            time.sleep(max(0.0, reqs[i].due - (time.monotonic() - t0)))
        else:
            break
        if now > seconds + DRAIN_S:
            break
    return handles, late


def answered(reqs, handles, t0: float, t1: float) -> tuple[list, list[float]]:
    """(the answered (request, result) pairs, every request's time to first
    token in order of arrival: an unanswered one counts as waiting until
    ``t1``)."""
    results = {r.index: h.result() for r, h in zip(reqs, handles) if h.done}
    done, ttft = [], []
    for r in reqs:
        res = results.get(r.index)
        if res is not None and res.status == "completed" and res.tokens:
            done.append((r, res))
            ttft.append(res.first_token_at - (t0 + r.due))
        else:
            ttft.append(t1 - (t0 + r.due))
    return done, ttft


def sample(reqs, n: int, seed: int) -> list[int]:
    """Indices of the checked requests: the longest prompt, and the rest of
    ``n`` drawn from the seed."""
    order = sorted(range(len(reqs)), key=lambda j: (-len(reqs[j].prompt), j))
    rest = order[1:]
    pick = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**63 - 1), 5]))
    n_more = min(n - 1, len(rest))
    return order[:1] + [rest[j] for j in sorted(pick.choice(len(rest), n_more, replace=False))]


def make_engine(spec, seed: int, device: str, t_start: float):
    """Set-up: the kernels, the benchmark's weights in a parameter tree, the
    engine and its timing session, warmed up by one request at the shortest
    and one at the longest length of the mix.  Returns (engine, session,
    weights)."""
    import torch

    from repro_torch.serving import Request, ServeSession
    from repro_torch.timing import TimingSession

    conf, tr, load = spec.config, spec.traffic, spec.load
    run_ = conf["run"]
    layers = conf["num_hidden_layers"]
    cfg = program.arch_config(conf, layers)
    if torch.device(device).type == "cuda":
        program.build_kernels()
    weights = Weights(run_, seed, layers, device)
    params = program.build_params(cfg, weights)
    harness.log(t_start, "weights made")
    sess = TimingSession()
    engine = ServeSession(cfg, params, session=sess, n_slots=load["n_slots"],
                          max_seq=tr["max_seq"], device=device)
    lo, hi = tr["text_len"]["min"], tr["text_len"]["max"]
    warm = np.random.default_rng(int(seed) & (2**63 - 1))
    for i, n in enumerate((lo, hi)):
        engine.submit(Request(-1 - i, warm.integers(0, run_["vocab_size"], n).tolist(),
                              max_new_tokens=tr["max_new_tokens"]))
    engine.run_until_idle()
    harness.log(t_start, "engine warmed up")
    return engine, sess, weights


def run(spec, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    import torch

    from repro_torch.serving import Request

    from .trace import Tracer

    conf, tr, load = spec.config, spec.traffic, spec.load
    run_ = conf["run"]
    layers = conf["num_hidden_layers"]
    cuda = torch.device(device).type == "cuda"
    engine, sess, weights = make_engine(spec, seed, device, t_start)
    reqs = serve_requests(tr, run_, load["rate_per_s"], seconds, seed)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    opened = program.timer_record(sess.db)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer() if trace else None
    if tracer is not None:
        tracer.start()
    t0 = time.monotonic()
    handles, late = open_loop(engine, Request, reqs, seconds, tr["max_new_tokens"], t0)
    sync()
    t1 = time.monotonic()
    if tracer is not None:
        tracer.stop()
    spans, counters = harness.window_record(opened, program.timer_record(sess.db))
    prefill_s = spans.get("serve/prefill", (0.0, 0.0))[0]
    harness.log(t_start, f"window closed: {len(handles)} requests in {t1 - t0:.3f} s, "
                f"serve/prefill {prefill_s:.3f} s (set-up {setup_s:.3f} s, generator late "
                f"by up to {late:.4f} s)")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    done, ttft_all = answered(reqs, handles, t0, t1)
    wait = [res.admitted_at - (t0 + r.due) for r, res in done]
    missing = len(reqs) - len(done)
    window_s = t1 - t0
    e2e = {"ttft_p95_ms": 1e3 * _p95(ttft_all), "setup_s": setup_s}
    flops = sum(work.prefill_flops(run_, len(r.prompt), layers) for r, _ in done)
    attn = [work.attention_fwd(run_, 1, run_.get("n_vision_patches", 0) + len(r.prompt), layers)
            for r, _ in done]
    ctx = harness.Context(spec, window_s, trace=tracer.trace() if tracer else None, values={
        "requests": len(reqs), "done": len(done), "prefill_flops": flops,
        "queue_wait_p95_ms": 1e3 * _p95(wait) if wait else None,
        "attn_fwd": (sum(a[0] for a in attn), sum(a[1] for a in attn)),
        "generator_late_s": late,
    }, spans=spans, counters=counters)
    del engine, sess
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    chosen = [done[j] for j in sample([r for r, _ in done], load["sample"], seed)]
    tokens = [res.tokens[0] for _, res in chosen]
    logits = harness.reference_module(spec).prefill_last_logits(
        run_, weights, [r.prompt for r, _ in chosen])
    harness.log(t_start, f"reference done ({len(chosen)} requests)")
    numbers = compare.serve_numbers(tokens, logits)
    checks = {k: (numbers[k], lim) for k, lim in load["limits"].items()}
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "attempted": len(reqs),
            "failed": missing, "memory_peak": peak, "late_s": late}
