"""The yardstick's work counts against figures worked by hand."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from portbench import work
from portbench.traffic import length_quantiles


def _run(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["run"]


def test_internvl_training_step_is_62_9_tflop():
    f = work.train_step_flops(_run("internvl2-26b"), batch=4, text_len=1024, layers=4)
    # 6 x 390.07 M params x 5,120 positions; 6 x 6144 x 92553 x 4,096 head; attention
    assert f["matmul"] == pytest.approx(6 * 4 * 390_070_272 * 5120)
    assert f["matmul"] / 1e12 == pytest.approx(47.93, abs=0.01)
    assert f["head"] / 1e12 == pytest.approx(13.97, abs=0.01)
    assert f["attention"] / 1e12 == pytest.approx(0.967, abs=0.001)
    assert f["total"] / 1e12 == pytest.approx(62.9, abs=0.05)
    assert f["positions"] == 5120


def test_moonshot_training_step_is_15_2_tflop():
    f = work.train_step_flops(_run("moonshot-v1-16b-a3b"), batch=4, text_len=1024, layers=4)
    # attention 4 x 2048^2, six routed experts of 3 x 2048 x 1408, router 2048 x 64
    per_layer = 4 * 2048 * 2048 + 6 * 3 * 2048 * 1408 + 2048 * 64
    assert f["matmul"] == pytest.approx(6 * 4 * per_layer * 4096)
    assert f["head"] / 1e12 == pytest.approx(8.246, abs=0.001)
    assert f["total"] / 1e12 == pytest.approx(15.2, abs=0.05)


def test_mean_classification_prefill_is_about_52_tflop():
    run = _run("internvl2-26b")
    spec = json.loads((ROOT / "portbench" / "traffic" / "classify-512-2048.json").read_text())
    lengths = length_quantiles(spec["text_len"], 280)
    assert sum(lengths) / len(lengths) + 256 == pytest.approx(1364, abs=10)
    mean = sum(work.prefill_flops(run, n, 48) for n in lengths) / len(lengths)
    assert mean / 1e12 == pytest.approx(52.2, abs=0.5)


def test_attention_backward_is_twice_the_forward_and_bytes_count_each_tensor_once():
    run = _run("internvl2-26b")
    f_flops, f_bytes = work.attention_fwd(run, 1, 1280, 1)
    b_flops, b_bytes = work.attention_bwd(run, 1, 1280, 1)
    assert b_flops == 2 * f_flops
    assert f_flops == 4 * 128 * 48 * (1280 * 1281 // 2)
    # q, o (48 heads) and k, v (8 heads) in bf16, the f32 lse
    assert f_bytes == 2 * 1280 * 128 * (2 * 48 + 2 * 8) + 4 * 48 * 1280
    assert b_bytes > f_bytes


def test_least_seconds_is_the_larger_bound():
    assert work.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)
