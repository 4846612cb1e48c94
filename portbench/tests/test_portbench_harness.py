"""The harness: what it finds by name, the line it prints, what it imports."""

from __future__ import annotations

import ast
import json
import shutil

import pytest
from conftest import ROOT

from portbench import harness, run as run_py


def test_every_cell_finds_its_files_and_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = harness.load_spec(cell["name"])
        names = {m["name"] for m in harness.per_layer_for(spec)}
        e2e = {m["name"] for m in harness.end_to_end_for(spec)}
        assert "setup_s" in e2e and len(e2e) >= 2 and names
        for name in names:
            assert harness.metric_path(ROOT, name).exists(), name
        assert spec.traffic["kind"] in ("train", "serve")
        for key in spec.load["limits"]:
            assert key in ("loss_gap", "grad_gap", "delta_gap", "grad_diff_median", "logit_gap")
    assert harness.op_patterns(ROOT, "attn_fwd") and harness.op_patterns(ROOT, "attn_bwd")


def test_files_added_alone_add_a_configuration_a_cell_and_a_metric(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/internvl2-26b.json").read_text())
    conf["name"] = "new-model"
    (tmp_path / "portbench/configs/new-model.json").write_text(json.dumps(conf))
    (tmp_path / "portbench/workloads/new-model.chat.json").write_text(
        json.dumps({"rate_per_s": 1.0, "n_slots": 2, "sample": 4, "limits": {"logit_gap": 1}}))
    (tmp_path / "portbench/traffic/chat.json").write_text(json.dumps(
        {"kind": "serve", "text_len": {"dist": "log_uniform", "min": 4, "max": 8},
         "max_new_tokens": 1, "max_seq": 300}))
    (tmp_path / "portbench/metrics/new_share.serve.py").write_text(
        "def read(ctx):\n"
        "    seconds, n = ctx.spans.get('serve/decode', (0.0, 0.0))\n"
        "    return 1e3 * seconds / n if n else None\n")
    (tmp_path / "portbench/ops/attn_fwd/new_kernel.json").write_text(
        json.dumps({"patterns": ["new_attention_kernel"]}))
    bench["configs"].append({"name": "new-model", "source": "x", "file":
                             "portbench/configs/new-model.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-model.chat", "config": "new-model",
                               "traffic": "chat", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_share.serve", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "ttft_p95_ms"})
    bench["end_to_end"][1]["workloads"].append("new-model.chat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_spec("new-model.chat", root=tmp_path)
    assert spec.config["name"] == "new-model" and spec.traffic["max_seq"] == 300
    names = [m["name"] for m in harness.per_layer_for(spec)]
    assert names == ["new_share.serve"]  # the others list their cells
    ctx = harness.Context(spec, 1.0, spans={"serve/decode": (0.5, 4.0)})
    assert harness.read_metric(tmp_path, "new_share.serve", ctx) == 125.0
    assert harness.read_metric(tmp_path, "new_share.serve", harness.Context(spec, 1.0)) is None
    assert "new_attention_kernel" in harness.op_patterns(tmp_path, "attn_fwd")
    # the cells already there are unchanged
    assert harness.per_layer_for(harness.load_spec("internvl2-26b.train", root=tmp_path)) == \
        harness.per_layer_for(harness.load_spec("internvl2-26b.train"))


def test_result_line_has_the_contract_keys_and_the_checks_last():
    spec = harness.load_spec("internvl2-26b.train")
    out = {"e2e": {"train_tokens_per_s": 15000.5, "setup_s": 20.25}, "ctx": None,
           "checks": {"loss_gap": (1e-5, 1e-4), "grad_gap": (float("nan"), 4e-3)},
           "attempted": 12, "failed": 0}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 5}
    line = json.loads(run_py.assemble(spec, out, False, device))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False  # a check that reads no number fails
    assert line["metrics"] == {"train_tokens_per_s": {"value": 15000.5, "unit": "tokens/s"},
                               "setup_s": {"value": 20.25, "unit": "s"}}
    assert line["checks"]["grad_gap"] == {"value": harness.UNREADABLE, "limit": 4e-3}
    out["checks"]["grad_gap"] = (1e-3, 4e-3)
    assert json.loads(run_py.assemble(spec, out, False, device))["correct"] is True
    out["failed"] = 1
    assert json.loads(run_py.assemble(spec, out, False, device))["correct"] is False


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "portbench").rglob("*.py")))
def test_nothing_imports_jax_or_the_jax_package(path):
    names = _imports(ROOT / path)
    assert not names & set(harness.FORBIDDEN), names


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("repro_torchlike"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def test_no_card_means_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_py.main(["--workload", "internvl2-26b.train", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_configuration_files_hold_what_they_run():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        conf = json.loads((ROOT / entry["file"]).read_text())
        run = conf["run"]
        assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
        assert sorted(conf["reduced"]) == sorted(entry["reduced"])
        assert run["d_model"] == conf["hidden_size"]
        assert run["n_heads"] == conf["num_attention_heads"]
        assert run["n_kv_heads"] == conf["num_key_value_heads"]
        assert run["vocab_size"] == conf["vocab_size"]
        assert run["norm_eps"] == conf["rms_norm_eps"] and run["rope_theta"] == conf["rope_theta"]
        assert conf["departures"] and conf["deployment"] and conf["assumed"]
        if run["moe"]:
            assert run["moe"]["n_experts"] == conf["n_routed_experts"]
            assert run["moe"]["top_k"] == conf["num_experts_per_tok"]
            assert run["moe"]["d_expert"] == conf["moe_intermediate_size"]
            assert run["head_dim"] == conf["v_head_dim"]
        else:
            assert run["d_ff"] == conf["intermediate_size"] and run["head_dim"] == conf["head_dim"]
