"""The reduction of a traced window, and the metric readers, on made-up
traces (a device number is never read on the CPU)."""

from __future__ import annotations

import pytest
from conftest import ROOT

from portbench import harness
from portbench.trace import Trace, idle_gaps, union_seconds

MS = 1_000_000


def test_union_counts_overlapping_operations_once():
    ops = [(0, 10 * MS), (5 * MS, 15 * MS), (20 * MS, 30 * MS), (25 * MS, 26 * MS)]
    assert union_seconds(ops, 0, 40 * MS) == pytest.approx(0.025)
    assert union_seconds(ops, 8 * MS, 22 * MS) == pytest.approx(0.009)
    assert idle_gaps(ops, 0, 40 * MS) == [(15 * MS, 20 * MS), (30 * MS, 40 * MS)]


def test_breakdown_names_the_top_operations_and_what_the_host_did_in_the_gaps():
    ops = [("gemm", 0, 10 * MS), ("flash_fwd_tc_kernel<128>", 10 * MS, 14 * MS),
           ("gemm", 20 * MS, 30 * MS)]
    samples = [(t * MS, "repro_torch/launch/train.py:fetch_data" if 14 <= t < 20 else "x")
               for t in range(0, 40, 2)]
    tr = Trace(ops, 0, 40 * MS, samples)
    assert tr.busy_s == pytest.approx(0.024) and tr.window_s == pytest.approx(0.040)
    assert tr.op_seconds(["flash_fwd"]) == pytest.approx(0.004)
    out = tr.breakdown()
    assert out["device_ops"][0] == ["gemm", pytest.approx(0.020)]
    assert out["idle_gaps"][0] == ["x", pytest.approx(0.010)]
    assert out["idle_gaps"][1] == ["repro_torch/launch/train.py:fetch_data",
                                   pytest.approx(0.006)]


def test_metric_readers_on_a_made_up_training_window():
    spec = harness.load_spec("internvl2-26b.train")
    flops, bytes_ = 2e12, 1e9
    ops = [("flash_fwd_tc_kernel<128>", 0, 10 * MS), ("flash_bwd_dq_tc_kernel", 10 * MS, 30 * MS),
           ("nvjet", 30 * MS, 90 * MS)]
    ctx = harness.Context(spec, 0.1, trace=Trace(ops, 0, 100 * MS, []), values={
        "steps": 2, "flops_per_step": 4.945e12,
        "attn_fwd_per_step": (flops, bytes_), "attn_bwd_per_step": (2 * flops, bytes_)},
        spans={"EVOL/trainer::train_step": (0.09, 2.0)})
    read = {m["name"]: harness.read_metric(ROOT, m["name"], ctx)
            for m in harness.per_layer_for(spec)}
    assert read["schedule_host_ms.train"] == pytest.approx(5.0)
    assert read["step_mfu.train"] == pytest.approx(10.0, rel=1e-3)
    assert read["attn_fwd_roofline.train"] == pytest.approx(100 * 4e12 / 989e12 / 0.010)
    assert read["attn_bwd_roofline.train"] == pytest.approx(100 * 8e12 / 989e12 / 0.020)
    assert read["device_idle_share.train"] == pytest.approx(10.0)
    untraced = harness.Context(spec, 0.1, values=ctx.values)
    assert harness.read_metric(ROOT, "schedule_host_ms.train", untraced) is None  # no EVOL
    assert harness.read_metric(ROOT, "attn_fwd_roofline.train", untraced) is None
    assert harness.read_metric(ROOT, "device_idle_share.train", untraced) is None


def test_a_roofline_with_no_matching_operation_reads_nothing():
    spec = harness.load_spec("internvl2-26b.serve-classify")
    ctx = harness.Context(spec, 1.0, trace=Trace([("nvjet", 0, MS)], 0, 2 * MS, []),
                          values={"attn_fwd": (1e12, 1e9), "prefill_flops": 989e12 * 0.25,
                                  "queue_wait_p95_ms": 12.5},
                          spans={"serve/prefill": (0.5, 3.0)})
    assert harness.read_metric(ROOT, "attn_fwd_roofline.serve", ctx) is None
    assert harness.read_metric(ROOT, "prefill_mfu.serve", ctx) == pytest.approx(50.0)
    assert harness.read_metric(ROOT, "queue_wait_p95_ms.serve", ctx) == 12.5
    assert harness.read_metric(ROOT, "device_idle_share.serve", ctx) == pytest.approx(50.0)


def test_window_record_takes_what_each_timer_and_counter_gained():
    opened = ({"EVOL/trainer::train_step": (3.0, 3.0), "gone": (1.0, 1.0)}, {"tokens": 10.0})
    closed = ({"EVOL/trainer::train_step": (5.5, 8.0), "serve/prefill": (0.25, 1.0)},
              {"tokens": 30.0, "steps": 5.0})
    spans, counters = harness.window_record(opened, closed)
    assert spans == {"EVOL/trainer::train_step": (2.5, 5.0), "serve/prefill": (0.25, 1.0)}
    assert counters == {"tokens": 20.0, "steps": 5.0}
