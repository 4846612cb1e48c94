"""The readers over the program's span log and device-event counters, on
made-up traces and span logs with known gaps; a ``--trace 0`` run of the
harness leaves the span log empty; and, on the card, a span around a kernel
reads the kernel's CUDA-event time."""

from __future__ import annotations

import pytest
from conftest import ROOT, tiny_spec

from portbench import harness, spans
from portbench.trace import Trace
from repro_torch.timing import SpanEntry

MS = 1_000_000


def _span(path, parent, start, end):
    return SpanEntry(path, parent, start * MS, end * MS)


def _log(monkeypatch, entries):
    monkeypatch.setattr(spans, "span_log", lambda lo, hi: [
        e for e in entries if e.end_ns >= lo and e.start_ns <= hi])


def _train_ctx(trace=True):
    """Two steps in [0, 100] ms; idle gaps 12-14 (under a window below model/moe),
    20-22 (model/moe), 30-31 (model/moe has just ended), 52-55 (the
    recompute's model/moe on autograd's thread, while the main thread waits in
    train_step/grads) and 80-85 (train_step/optimizer): 7 ms under MoE."""
    spec = harness.load_spec("moonshot-v1-16b-a3b.train")
    ops = [("k", 0, 12 * MS), ("k", 14 * MS, 20 * MS), ("k", 22 * MS, 30 * MS),
           ("k", 31 * MS, 52 * MS), ("k", 55 * MS, 80 * MS), ("k", 85 * MS, 100 * MS)]
    return harness.Context(spec, 0.1, trace=Trace(ops, 0, 100 * MS, []) if trace else None,
                           values={"steps": 2, "flops_per_step": 1e12,
                                   "attn_fwd_per_step": (1e9, 1e6),
                                   "attn_bwd_per_step": (2e9, 1e6)},
                           counters={"train_step/optimizer/device_s": 0.05,
                                     "train_step/grads/device_s": 0.12,
                                     "model/moe/device_s": 0.02})


TRAIN_LOG = [
    _span("model/moe/inner", "model/moe", 10, 15),
    _span("model/moe", "train_step/grads", 10, 30),
    _span("model/moe", None, 50, 60),  # the recompute, on autograd's thread
    _span("train_step/grads", "EVOL/trainer::train_step", 0, 70),
    _span("train_step/optimizer", "EVOL/trainer::train_step", 70, 100),
    _span("EVOL/trainer::train_step", "bin/EVOL", -1, 101),
]


def test_training_readers_on_a_made_up_window(monkeypatch):
    _log(monkeypatch, TRAIN_LOG)
    ctx = _train_ctx()
    read = {m["name"]: harness.read_metric(ROOT, m["name"], ctx)
            for m in harness.per_layer_for(ctx.spec)}
    assert read["optimizer_device_ms.train"] == pytest.approx(25.0)
    assert read["grads_device_ms.train"] == pytest.approx(60.0)
    assert read["moe_device_ms.train"] == pytest.approx(10.0)
    assert read["moe_idle_ms.train"] == pytest.approx(3.5)
    idle_s = ctx.trace.window_s - ctx.trace.busy_s
    assert read["moe_idle_ms.train"] * 2 / 1e3 <= idle_s
    assert spans.idle_under_s(ctx, "train_step/optimizer") == pytest.approx(0.005)
    assert spans.idle_under_s(ctx, "train_step/grads") == pytest.approx(0.001)  # 30-31


def test_prefill_idle_on_a_made_up_window(monkeypatch):
    """Prefills at [-5, 5] (clipped to the window), [10, 40] and [60, 90] ms;
    idle gaps 3-7, 20-25, 50-65, 95-100: 2 + 5 + 5 ms inside, 4 ms a prefill."""
    _log(monkeypatch, [
        _span("serve/prefill", "serve", -5, 5),
        _span("model/moe", "serve/prefill", 10, 30),
        _span("serve/prefill", "serve", 10, 40),
        _span("serve/decode", "serve", 40, 60),
        _span("serve/prefill", "serve", 60, 90),
    ])
    spec = harness.load_spec("internvl2-26b.serve-classify")
    ops = [("k", 0, 3 * MS), ("k", 7 * MS, 20 * MS), ("k", 25 * MS, 50 * MS),
           ("k", 65 * MS, 95 * MS)]
    ctx = harness.Context(spec, 0.1, trace=Trace(ops, 0, 100 * MS, []),
                          values={"queue_wait_p95_ms": 1.0, "prefill_flops": 1e12,
                                  "attn_fwd": (1e9, 1e6)})
    assert harness.read_metric(ROOT, "prefill_idle_ms.serve", ctx) == pytest.approx(4.0)
    assert spans.idle_inside_s(ctx, "serve/prefill") == (pytest.approx(0.012), 3)
    assert spans.idle_inside_s(ctx, "serve/decode") == (pytest.approx(0.010), 1)  # 50-60


@pytest.mark.parametrize("name", ["optimizer_device_ms.train", "grads_device_ms.train",
                                  "moe_device_ms.train", "moe_idle_ms.train",
                                  "prefill_idle_ms.serve"])
def test_readers_read_nothing_without_a_trace_or_a_span_log(monkeypatch, name):
    _log(monkeypatch, TRAIN_LOG)
    untraced = _train_ctx(trace=False)
    assert harness.read_metric(ROOT, name, untraced) is None
    # a program without a span log or device counters; a log without the windows read
    for log in (None, [_span("serve/decode", "serve", 0, 100)]):
        monkeypatch.setattr(spans, "span_log", lambda lo, hi, log=log: log)
        bare = _train_ctx()
        bare.counters = {}
        assert harness.read_metric(ROOT, name, bare) is None


def test_an_untraced_run_leaves_the_span_log_empty():
    """``--trace 0``: the recorder stays off, so no window is logged and no
    ``device_s`` counter exists."""
    from portbench import run as run_py
    from repro_torch.core.clocks import counter_names
    from repro_torch.core.timers import _SPAN_LOG

    _SPAN_LOG.clear()
    spec = tiny_spec("tiny-moe.json", "tiny-train.json", {"loss_gap": 1.0})
    out = run_py.run_cell(spec, 5, 0.2, False, "cpu")
    assert out["ctx"].spans["EVOL/trainer::train_step"][1] >= 1
    assert out["ctx"].spans["model/moe"][1] >= 1
    assert len(_SPAN_LOG) == 0
    assert not [n for n in counter_names() if n.endswith("/device_s")]


@pytest.mark.cuda
def test_a_span_reads_the_device_time_of_its_kernel(cuda_device):
    """Inside a ``Tracer`` window, a span around twenty 8192^2 bf16 products
    reads in ``<path>/device_s`` the CUDA-event time of those products, to
    5%."""
    import torch

    from portbench.trace import Tracer
    from repro_torch.core.clocks import counter_channel, resolve_device_events
    from repro_torch.timing import TimerDB

    a = torch.randn(8192, 8192, device=cuda_device, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    db = TimerDB()
    probe = db.scope_handle("portbench_test/probe")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tracer = Tracer()
    tracer.start()
    with probe:
        start.record()
        for _ in range(20):
            a @ a
        end.record()
    torch.cuda.synchronize()
    tracer.stop()
    assert resolve_device_events() >= 1
    want = start.elapsed_time(end) / 1e3
    assert want > 0.01
    assert counter_channel("portbench_test/probe/device_s") == pytest.approx(want, rel=0.05)
