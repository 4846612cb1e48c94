"""The check that decides ``correct``: the reference agrees with the port
where both compute alike, the harness driven on the CPU at test size sees
``correct`` come out false under each fault a cell can have, and the control
(the reference in fp8) fails it.  The chip runs the same at the cells' own
sizes (``portbench/control.py``; ``test_controls_fail_at_the_cells_size``)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, load, tiny_spec

from portbench import compare, harness, run as run_py
from portbench.reference import transformer as ref
from portbench.traffic import TrainData
from portbench.weights import Weights

#: limits at test size, above what sound runs of the tiny configurations read
#: (bf16 against f32, seeds 1-6: vlm loss 2e-4, gradient 1e-3, change 1e-3;
#: moe, whose 8 experts see near-tied routes flip, loss 2.5e-3, gradient
#: 6.6e-2, change 8.5e-3, median leaf's gradient difference 0.16 (fp8: 0.6);
#: the first served token exact)
TRAIN_LIMITS = {"tiny-vlm.json": {"loss_gap": 1e-3, "grad_gap": 1e-2, "delta_gap": 1e-2},
                "tiny-moe.json": {"loss_gap": 6e-3, "grad_gap": 0.2, "delta_gap": 0.05,
                                  "grad_diff_median": 0.35}}
SERVE = dict(rate_per_s=20.0, n_slots=2, sample=6)
SERVE_LIMITS = {"logit_gap": 0.05}


def _line(spec, seed=3, seconds=1.0):
    out = run_py.run_cell(spec, seed, seconds, False, "cpu")
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return json.loads(run_py.assemble(spec, out, False, device))


def _f32(spec):
    spec.config["run"]["dtype"] = "float32"
    return spec


@pytest.mark.parametrize("config", sorted(TRAIN_LIMITS))
def test_reference_trains_as_the_port_in_f32(config):
    limits = {"loss_gap": 1e-5, "grad_gap": 1e-5, "delta_gap": 1e-5, "grad_diff_median": 1e-4}
    line = _line(_f32(tiny_spec(config, "tiny-train.json", limits)))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("config", ["tiny-vlm.json", "tiny-moe.json"])
def test_reference_prefill_logits_match_the_port_in_f32(config):
    from portbench import program
    from repro_torch.models import model as M

    conf = load(config)
    conf["run"]["dtype"] = "float32"
    layers = conf["num_hidden_layers"]
    weights = Weights(conf["run"], 11, layers, "cpu")
    cfg = program.arch_config(conf, layers)
    params = program.build_params(cfg, weights)
    prompts = [[5, 7, 11, 13, 17, 19], list(range(3, 40))]
    got = ref.prefill_last_logits(conf["run"], weights, prompts)
    for prompt, want in zip(prompts, got):
        batch = {"tokens": torch.tensor([prompt])}
        if cfg.n_vision_patches:
            batch["patch_embeds"] = torch.zeros(1, cfg.n_vision_patches, cfg.d_model)
        _, logits = M.prefill(cfg, params, batch, M.init_cache(cfg, 1, 64, device="cpu"))
        assert torch.allclose(logits[0, :cfg.vocab_size], want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("config", sorted(TRAIN_LIMITS))
def test_training_faults_make_correct_false(config, monkeypatch):
    from repro_torch.launch import steps

    spec = tiny_spec(config, "tiny-train.json", TRAIN_LIMITS[config])
    assert _line(spec)["correct"]

    # a step that returns its state unchanged
    with monkeypatch.context() as m:
        m.setattr(steps, "adamw_update", lambda cfg, params, grads, state, lr, gnorm=None: (
            params, state, {"grad_norm": torch.ones(()), "clip_scale": torch.ones(())}))
        line = _line(spec)
        assert not line["correct"] and line["checks"]["delta_gap"]["value"] == pytest.approx(1.0)

    # half of the batch left out, the mean taken over the rest
    grads = steps._grads
    with monkeypatch.context() as m:
        m.setattr(steps, "_grads", lambda cfg, params, batch: grads(
            cfg, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))
        assert not _line(spec)["correct"]

    # every step trained on a batch other than the one the reference takes
    skip = TrainData.next
    with monkeypatch.context() as m:
        m.setattr(TrainData, "next", lambda self: (skip(self), skip(self))[1])
        line = _line(spec)
        assert not line["correct"] and line["checks"]["batch_mismatch"]["value"] == 3


def test_a_served_token_altered_where_it_is_produced_makes_correct_false(monkeypatch):
    from repro_torch.serving import engine

    spec = tiny_spec("tiny-vlm.json", "tiny-serve.json", SERVE_LIMITS, **SERVE)
    assert _line(spec)["correct"]
    prefill = engine.M.prefill

    def altered(cfg, params, batch, cache):
        cache, logits = prefill(cfg, params, batch, cache)
        wrong = (logits[..., : cfg.vocab_size].argmax(-1) + 1) % cfg.vocab_size
        return cache, logits.scatter(-1, wrong[..., None], float(logits.max()) + 1.0)

    monkeypatch.setattr(engine.M, "prefill", altered)
    assert not _line(spec)["correct"]


def test_metric_readers_read_the_timers_the_runners_record(tmp_path):
    """Every timer of the program's timer DB reaches the readers as what it
    gained in the window, so a metric over a timer is a file alone."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    (tmp_path / "portbench/metrics/prefill_ms.serve.py").write_text(
        "def read(ctx):\n"
        "    seconds, n = ctx.spans.get('serve/prefill', (0.0, 0.0))\n"
        "    return 1e3 * seconds / n if n else None\n")
    spec = tiny_spec("tiny-vlm.json", "tiny-serve.json", SERVE_LIMITS, **SERVE)
    ctx = run_py.run_cell(spec, 3, 1.0, False, "cpu")["ctx"]
    seconds, n = ctx.spans["serve/prefill"]
    assert seconds > 0.0 and n >= 1 and ctx.values["done"] >= 1
    read = harness.read_metric(tmp_path, "prefill_ms.serve", ctx)
    assert read == pytest.approx(1e3 * seconds / n)
    assert harness.read_metric(ROOT, "prefill_mfu.serve", ctx) > 0.0

    spec = tiny_spec("tiny-vlm.json", "tiny-train.json", TRAIN_LIMITS["tiny-vlm.json"])
    out = run_py.run_cell(spec, 3, 1.0, False, "cpu")
    seconds, steps = out["ctx"].spans["EVOL/trainer::train_step"]
    assert steps == out["ctx"].values["steps"] and 0.0 < seconds < out["ctx"].window_s
    assert harness.read_metric(ROOT, "schedule_host_ms.train", out["ctx"]) > 0.0
    assert out["checks"]["batch_mismatch"] == (0.0, 0.0)


@pytest.mark.parametrize("config", sorted(TRAIN_LIMITS))
def test_the_fp8_control_fails_the_training_check_at_test_size(config):
    conf, spec = load(config), load("tiny-train.json")
    for seed in (1, 2, 3):
        weights = Weights(conf["run"], seed, conf["train_layers"], "cpu")
        batches = [TrainData(spec, conf["run"], seed).batch_at(i) for i in range(3)]
        base = ref.train_steps(conf["run"], spec, weights, batches, keep_grad=True)
        low = ref.train_steps(conf["run"], spec, weights, batches, prec="fp8", keep_grad=True)
        numbers = compare.train_numbers(low, base)
        assert any(numbers[k] > lim for k, lim in TRAIN_LIMITS[config].items()), numbers


def test_the_fp8_control_fails_the_serving_check_at_test_size():
    conf = load("tiny-vlm.json")
    for seed in (1, 2, 3):
        weights = Weights(conf["run"], seed, conf["num_hidden_layers"], "cpu")
        g = torch.Generator().manual_seed(seed)
        prompts = [torch.randint(0, 250, (n,), generator=g).tolist() for n in range(8, 40, 2)]
        base = ref.prefill_last_logits(conf["run"], weights, prompts)
        low = ref.prefill_last_logits(conf["run"], weights, prompts, prec="fp8")
        tokens = [int(x.argmax()) for x in low]
        assert compare.serve_numbers(tokens, base)["logit_gap"] > SERVE_LIMITS["logit_gap"]


@pytest.mark.cuda
def test_controls_fail_at_the_cells_size(cuda_device):
    """``control.py`` on three seeds a cell: the fp8 control fails one of the
    cell's limits on every seed, and so does the half-batch fault."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        limits = json.loads((ROOT / "portbench/workloads" / f"{cell['name']}.json").read_text())
        out = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell["name"],
                              "--seeds", "91,92,93"], cwd=ROOT, capture_output=True, text=True,
                             check=True, timeout=1500)
        rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        assert len(rows) >= 3
        for row in rows:
            assert any(row[k] > lim for k, lim in limits["limits"].items()), row
