"""PyTorch port, monitor surfaces: the cases of ``tests/test_export.py`` and
the monitor cases of ``tests/test_report_params_monitor.py`` on the port's
``monitor`` package, then the same timer and counter operations under a
fixed clock fed to the reference's and the port's ``TimerDB``: both
expositions pass their strict parsers with the same families, series and
types, and equal values wherever a value does not read the real clock."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from repro_torch.core import clocks as C
from repro_torch.core.params import param_registry
from repro_torch.core.timers import PARENT_STATS_CAP, TimerDB, timer_db
from repro_torch.monitor import (
    TEXT_CONTENT_TYPE,
    MetricsExporter,
    MonitorServer,
    StatusWriter,
    parse_exposition,
)
from repro_torch.monitor.export import MetricFamily
from repro_torch.monitor.promparse import ExpositionError, main as promparse_main

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's)."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    yield
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()


# ---------------------------------------------------------------------------
# exporter -> parser round trip
# ---------------------------------------------------------------------------

def _tree_db() -> TimerDB:
    db = TimerDB()
    with db.scope("train"):
        with db.scope("step"):
            pass
        with db.scope("io"):
            pass
    with db.scope("train"):
        with db.scope("step"):
            pass
    return db


def test_render_parses_and_reports_tree():
    db = _tree_db()
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.types["repro_timer_windows_total"] == "counter"
    assert exp.value("repro_timer_windows_total", path="train", chain="") == 2.0
    assert exp.value("repro_timer_windows_total",
                     path="train/step", chain="train") == 2.0
    assert exp.value("repro_timer_windows_total",
                     path="train/io", chain="train") == 1.0
    # inclusive >= exclusive on the parent, both non-negative
    inc = exp.value("repro_timer_inclusive_seconds", path="train", chain="")
    exc = exp.value("repro_timer_exclusive_seconds", path="train", chain="")
    assert inc >= exc >= 0.0


def test_adapt_rows_become_labeled_counters():
    db = TimerDB()
    db.scope_handle("ADAPT/serving::grow").timer.count += 3
    db.scope_handle("ADAPT/stragglers::evict").timer.count += 1
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.value("repro_adapt_actions_total",
                     controller="serving", action="grow") == 3.0
    assert exp.value("repro_adapt_actions_total",
                     controller="stragglers", action="evict") == 1.0


def test_quarantine_rows_become_reason_counters():
    db = TimerDB()
    db.scope_handle("CHECKPOINT/quarantine::bad_hash").timer.count += 2
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.value("repro_checkpoint_quarantine_total", reason="bad_hash") == 2.0


def test_label_escaping_round_trip():
    db = TimerDB()
    weird = 'sc"ope\\with\nnewline'
    with db.scope(weird):
        pass
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.value("repro_timer_windows_total", path=weird, chain="") == 1.0


def test_counter_channels_exported():
    db = TimerDB()
    bump = C.increment_counter
    h = db.create("w")
    db.start(h)
    bump("export_test_channel", 5.0)
    db.stop(h)
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.value("repro_counter_total", channel="export_test_channel") >= 5.0
    # cells are process-global: the channel gauge counts at least this one
    assert exp.value("repro_timing_counter_channels") >= 1.0


def test_detector_section():
    from repro_torch.dist.stragglers import StragglerDetector

    db = TimerDB()
    det = StragglerDetector(3, window=2, threshold=1.5, db=db)
    for step in range(4):
        for host, cost in ((0, 0.1), (1, 0.1), (2, 0.5)):
            det.observe(host, cost)
        det.check(step)
    exp = parse_exposition(MetricsExporter(db, detector=det).render())
    assert exp.value("repro_host_windows_total", host="2") == 4.0
    assert exp.value("repro_host_slowdown_ratio", host="2") > 1.5
    assert exp.value("repro_host_flagged", host="2") == 1.0
    assert exp.value("repro_host_flagged", host="0") == 0.0
    assert exp.value("repro_host_evicted", host="2") == 0.0


def test_serving_section_from_payload():
    stats = {
        "completed": 7, "shed": 2, "steps": 40, "tokens": 300,
        "queue_depth": 3, "active_slots": 4, "max_active": 8,
        "occupancy": 0.5, "kv_utilization": 0.25,
    }
    exporter = MetricsExporter(
        TimerDB(), serving_fn=lambda: {"engine": stats, "requests": []}
    )
    exp = parse_exposition(exporter.render())
    assert exp.value("repro_serving_completed_total") == 7.0
    assert exp.value("repro_serving_shed_total") == 2.0
    assert exp.value("repro_serving_tokens_total") == 300.0
    assert exp.value("repro_serving_queue_depth") == 3.0
    assert exp.value("repro_serving_kv_utilization_ratio") == 0.25
    assert exp.types["repro_serving_completed_total"] == "counter"
    assert exp.types["repro_serving_queue_depth"] == "gauge"


def test_checkpoint_section_from_payload():
    payload = {
        "checkpoints": [{"step": 10, "path": "a"}, {"step": 30, "path": "b"}],
        "quarantined": [{"step": 20, "reason": "bad_hash"}],
        "totals": {"n_saves": 5, "total_bytes": 4096,
                   "total_blocking_seconds": 0.25},
    }
    exporter = MetricsExporter(TimerDB(), checkpoint_fn=lambda: payload)
    exp = parse_exposition(exporter.render())
    assert exp.value("repro_checkpoints_on_disk") == 2.0
    assert exp.value("repro_checkpoints_quarantined") == 1.0
    assert exp.value("repro_checkpoint_last_success_step") == 30.0
    assert exp.value("repro_checkpoint_saves_total") == 5.0
    assert exp.value("repro_checkpoint_write_bytes_total") == 4096.0
    assert exp.value("repro_checkpoint_blocking_seconds_total") == 0.25


def test_custom_namespace_and_validation():
    db = TimerDB()
    with db.scope("x"):
        pass
    exp = parse_exposition(MetricsExporter(db, namespace="myapp").render())
    assert exp.value("myapp_timer_windows_total", path="x", chain="") == 1.0
    with pytest.raises(ValueError, match="namespace"):
        MetricsExporter(db, namespace="0bad")


def test_metric_family_render_validation():
    with pytest.raises(ValueError, match="must be named"):
        MetricFamily("repro_things", "counter", "h", [({}, 1.0)]).render()
    with pytest.raises(ValueError, match="invalid metric name"):
        MetricFamily("1bad", "gauge", "h", [({}, 1.0)]).render()
    with pytest.raises(ValueError, match="invalid label name"):
        MetricFamily("ok_total", "counter", "h",
                     [({"__reserved": "x"}, 1.0)]).render()


def test_write_textfile_atomic(tmp_path):
    db = _tree_db()
    path = tmp_path / "metrics" / "repro.prom"
    MetricsExporter(db).write_textfile(str(path))
    text = path.read_text()
    assert text.endswith("\n")
    parse_exposition(text)
    assert not list(path.parent.glob("*.tmp"))
    # rewrite replaces in place
    with db.scope("more"):
        pass
    MetricsExporter(db).write_textfile(str(path))
    exp = parse_exposition(path.read_text())
    assert ("repro_timer_windows_total",
            (("chain", ""), ("path", "more"))) in exp.samples


# ---------------------------------------------------------------------------
# /metrics endpoint on the monitor server
# ---------------------------------------------------------------------------

def test_monitor_metrics_endpoint():
    db = _tree_db()
    server = MonitorServer(0, db)
    port = server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10
        ) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == TEXT_CONTENT_TYPE
            exp = parse_exposition(resp.read().decode())
        assert exp.value("repro_timer_windows_total", path="train", chain="") == 2.0
        # the other endpoints still work alongside
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/timers", timeout=10
        ) as resp:
            assert "train" in json.load(resp)
    finally:
        server.stop()


def test_monitor_metrics_custom_exporter():
    db = TimerDB()
    db.scope_handle("ADAPT/x::act").timer.count += 1
    server = MonitorServer(0, db, exporter=MetricsExporter(db, namespace="custom"))
    port = server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10
        ) as resp:
            exp = parse_exposition(resp.read().decode())
        assert exp.value("custom_adapt_actions_total",
                         controller="x", action="act") == 1.0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the strict parser: negative cases (what the CI gate actually catches)
# ---------------------------------------------------------------------------

GOOD = "# HELP m_total h\n# TYPE m_total counter\nm_total 1.0\n"


def test_parser_good_minimal():
    exp = parse_exposition(GOOD)
    assert exp.value("m_total") == 1.0
    assert exp.helps["m_total"] == "h"


@pytest.mark.parametrize(
    "text,match",
    [
        ("", "empty"),
        ("# TYPE m_total counter\nm_total 1.0", "final newline"),
        ("m_total 1.0\n", "no # TYPE"),
        ("# TYPE m_total counter\nm_total 1.0\n# TYPE m_total counter\n",
         "duplicate TYPE"),
        ("# TYPE m counter\nm 1.0\n", "must be named"),
        ("# TYPE m_total counter\nm_total 1.0\nm_total 1.0\n",
         "duplicate series"),
        ("# TYPE m_total counter\nm_total{a=\"1\"} 1\nm_total{a=\"1\"} 2\n",
         "duplicate series"),
        ("# TYPE m_total counter\nm_total{__a=\"1\"} 1\n", "invalid label"),
        ("# TYPE m_total counter\nm_total{a=\"\\t\"} 1\n", "invalid escape"),
        ("# TYPE m_total counter\nm_total{a=\"x} 1\n", "unterminated"),
        ("# TYPE m_total counter\nm_total bogus\n", "invalid sample value"),
        ("# TYPE m_total counter\nm_total\n", "expected: value"),
        ("# TYPE m_total weird\n", "unknown type"),
        ("# NOTE something\n", "unknown comment"),
        ("# HELP m_total a\n# HELP m_total b\n", "duplicate HELP"),
        ("# TYPE a_total counter\n# TYPE b gauge\na_total 1\nb 2\na_total 3\n",
         "not contiguous"),
        ("# TYPE 1bad gauge\n", "invalid metric name"),
    ],
)
def test_parser_rejects(text, match):
    with pytest.raises(ExpositionError, match=match):
        parse_exposition(text)


def test_parser_error_carries_lineno():
    with pytest.raises(ExpositionError) as err:
        parse_exposition("# TYPE m_total counter\nm_total bogus\n")
    assert err.value.lineno == 2


def test_parser_histogram_suffixes_and_timestamps():
    text = (
        "# TYPE lat histogram\n"
        'lat_bucket{le="0.1"} 3 1700000000\n'
        'lat_bucket{le="+Inf"} 5\n'
        "lat_sum 0.4\n"
        "lat_count 5\n"
    )
    exp = parse_exposition(text)
    assert exp.value("lat_bucket", le="+Inf") == 5.0
    assert exp.value("lat_count") == 5.0


def test_parser_escape_round_trip():
    text = '# TYPE g gauge\ng{p="a\\\\b\\"c\\nd"} 1\n'
    exp = parse_exposition(text)
    assert exp.value("g", p='a\\b"c\nd') == 1.0


def test_promparse_cli_gate(tmp_path, capsys):
    good = tmp_path / "good.prom"
    good.write_text(GOOD)
    bad = tmp_path / "bad.prom"
    bad.write_text("m_total 1.0\n")
    assert promparse_main([str(good)]) == 0
    assert promparse_main([str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[promparse] ok" in out and "[promparse] FAIL" in out


# ---------------------------------------------------------------------------
# parent-stats LRU cap: bounded buckets, eviction counter
# ---------------------------------------------------------------------------

def test_parent_stats_bucket_cap_and_eviction_metric():
    db = TimerDB()
    hot = db.scope_handle("hot")
    n = PARENT_STATS_CAP + 40
    for i in range(n):
        with db.scope(f"caller_{i}"):
            with hot:
                pass
    assert len(hot.timer._parent_stats) == PARENT_STATS_CAP
    assert hot.timer.parent_stats_evictions == 40
    card = db.cardinality()
    assert card["parent_stats_buckets_max"] <= PARENT_STATS_CAP
    assert card["parent_stats_evictions"] == 40
    exp = parse_exposition(MetricsExporter(db).render())
    assert exp.value("repro_timing_parent_stats_buckets_max") <= PARENT_STATS_CAP
    assert exp.value("repro_timing_parent_stats_evictions_total") == 40.0


def test_parent_stats_lru_keeps_recent_parents():
    db = TimerDB()
    hot = db.scope_handle("hot")
    for i in range(PARENT_STATS_CAP + 8):
        # caller_0 revisits hot every iteration: recently used, never evicted
        with db.scope("caller_0"):
            with hot:
                pass
        with db.scope(f"caller_{i + 1}"):
            with hot:
                pass
    stats = hot.timer.parent_stats()
    assert ("caller_0",) in stats
    count_0 = stats[("caller_0",)][1]
    assert count_0 == PARENT_STATS_CAP + 8
    # the oldest one-shot callers were evicted, the newest survive
    assert (f"caller_{PARENT_STATS_CAP + 8}",) in stats
    assert ("caller_1",) not in stats


def test_parent_stats_reset_clears_evictions():
    db = TimerDB()
    hot = db.scope_handle("hot")
    for i in range(PARENT_STATS_CAP + 5):
        with db.scope(f"c{i}"):
            with hot:
                pass
    assert hot.timer.parent_stats_evictions == 5
    db.reset_all()
    assert hot.timer.parent_stats_evictions == 0
    assert hot.timer.parent_stats() == {}


# ---------------------------------------------------------------------------
# the monitor cases of tests/test_report_params_monitor.py
# ---------------------------------------------------------------------------

def _populate_db():
    db = timer_db()
    for name in ("EVOL/trainer::step", "CHECKPOINT/adaptcheck::write", "simulation/total"):
        h = db.create(name)
        db.start(h)
        time.sleep(0.002)
        db.stop(h)
    return db


def test_status_writer_atomic(tmp_path):
    db = _populate_db()
    w = StatusWriter(str(tmp_path / "status.json"), db)
    w.write({"iteration": 3})
    payload = json.load(open(tmp_path / "status.json"))
    assert payload["status"]["iteration"] == 3
    assert "simulation/total" in payload["timers"]
    assert not list(tmp_path.glob("*.tmp"))


def test_monitor_http_endpoints():
    db = _populate_db()
    reg = param_registry()
    reg.declare("serving.max_batch", 8, steerable=True)
    srv = MonitorServer(0, db, reg, status_fn=lambda: {"iteration": 5},
                        checkpoint_fn=lambda: {"checkpoints": [{"step": 4, "path": "p"}]})
    port = srv.start()
    try:
        base = f"http://127.0.0.1:{port}"
        timers = json.loads(urllib.request.urlopen(base + "/timers").read())
        assert "simulation/total" in timers
        tree = json.loads(urllib.request.urlopen(base + "/tree").read())
        tree_names = {row["timer"] for row in tree}
        assert "simulation/total" in tree_names
        assert all({"inclusive_s", "exclusive_s", "children"} <= set(r) for r in tree)
        status = json.loads(urllib.request.urlopen(base + "/status").read())
        assert status["iteration"] == 5
        ckpts = json.loads(urllib.request.urlopen(base + "/checkpoints").read())
        assert ckpts["checkpoints"][0]["step"] == 4
        html = urllib.request.urlopen(base + "/").read().decode()
        assert "Timer report" in html
        # steering via POST (paper Sec. 5)
        req = urllib.request.Request(
            base + "/params",
            data=json.dumps({"name": "serving.max_batch", "value": 4}).encode(),
            method="POST",
        )
        resp = json.loads(urllib.request.urlopen(req).read())
        assert resp["ok"] and reg.get("serving.max_batch") == 4
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the port's exposition against the reference's
# ---------------------------------------------------------------------------

_PARITY_SCRIPT = """\
import json, sys
from importlib import import_module


def exposition(pkg):
    clocks = import_module(pkg + ".core.clocks")
    timers = import_module(pkg + ".core.timers")
    monitor = import_module(pkg + ".monitor")
    stragglers = import_module(pkg + ".dist.stragglers")
    clocks.reset_default_clocks()
    # the fixed clock: wall time advances only when the script says so
    now = {"t": 100.0}
    clocks.register_clock("walltime", lambda: clocks.CallbackClock(
        "walltime", lambda: {"walltime": now["t"]}, {"walltime": "s"}))
    clocks.unregister_clock("cputime")
    clocks.unregister_clock("perfcounter")
    db = timers.TimerDB()
    for step in range(3):
        with db.scope("train"):
            now["t"] += 0.5
            with db.scope("step"):
                now["t"] += 1.25
                clocks.increment_counter("parity_tokens", 64.0)
            if step == 1:
                with db.scope("io"):
                    now["t"] += 0.25
    db.scope_handle("ADAPT/adaptcheck::checkpoint").timer.count += 2
    db.scope_handle("CHECKPOINT/quarantine::leaf_hash_mismatch").timer.count += 1
    det = stragglers.StragglerDetector(2, window=2, threshold=1.5, db=db)
    for step in range(3):
        det.observe(0, 0.1)
        det.observe(1, 0.4)
        det.check(step)
    payload = {
        "checkpoints": [{"step": 3, "path": "a"}, {"step": 5, "path": "b"}],
        "quarantined": [{"step": 4, "reason": "missing_commit"}],
        "totals": {"n_saves": 2, "total_bytes": 4096, "total_blocking_seconds": 0.5},
    }
    return monitor.MetricsExporter(db, detector=det,
                                   checkpoint_fn=lambda: payload).render()


print(json.dumps({pkg: exposition(pkg) for pkg in sys.argv[1:]}))
"""

#: families whose values read the real clock at scrape time
_REAL_CLOCK = ("repro_scrape_monotonic_seconds", "repro_scrape_walltime_seconds")


def test_port_exposition_matches_the_reference():
    """Run in a fresh process: counter channels are process-global and never
    deleted, so only a process that made the same ones in both packages
    exports the same ``repro_counter_total`` series."""
    from repro.monitor import parse_exposition as jax_parse_exposition

    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _PARITY_SCRIPT, "repro", "repro_torch"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    pages = json.loads(out)
    ref = jax_parse_exposition(pages["repro"])
    mine = parse_exposition(pages["repro_torch"])
    assert mine.types == ref.types
    assert mine.helps == ref.helps
    assert set(mine.samples) == set(ref.samples)
    for key, value in ref.samples.items():
        if key[0] not in _REAL_CLOCK:
            assert mine.samples[key] == value, key
    # the fixed clock reached the timer tree: 3 x (0.5 + 1.25) + 0.25 seconds
    assert mine.value("repro_timer_inclusive_seconds", path="train", chain="") == 5.5
    assert mine.value("repro_counter_total", channel="parity_tokens") == 3 * 64.0
    assert mine.value("repro_adapt_actions_total", controller="adaptcheck",
                      action="checkpoint") == 2.0
    assert mine.value("repro_host_flagged", host="1") == 1.0


def test_serve_launcher_writes_a_textfile(tmp_path, capsys):
    """``python -m repro_torch.launch.serve --metrics-textfile F`` writes one
    page on exit that the strict parser accepts, with the engine's counts."""
    import torch

    from repro_torch.launch.serve import main as serve_main

    path = tmp_path / "serve.prom"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert serve_main(["--device", "cpu", "--requests", "3", "--prompt-len", "8",
                           "--max-new", "2", "--slots", "2",
                           "--metrics-textfile", str(path)]) == 0
    finally:
        torch.set_num_threads(threads)
    stats = json.loads(capsys.readouterr().out)
    exp = parse_exposition(path.read_text())
    assert exp.value("repro_serving_completed_total") == stats["completed"] == 3.0
    assert exp.value("repro_serving_tokens_total") == stats["tokens"]
    assert exp.types["repro_serving_queue_depth"] == "gauge"
    assert exp.value("repro_adapt_polls_total") >= 1.0
    assert promparse_main([str(path)]) == 0
