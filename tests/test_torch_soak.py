"""PyTorch port, the soak harness and the fault drills (``repro_torch.soak``,
``repro_torch.faults.soak``): the reference's cases (``tests/test_soak.py``:
live train and serve soaks on the CPU, scraped over HTTP or rendered, the
CLI, and the invariant checker's teeth on synthetic snapshot sequences), then
the port held against the JAX package: every synthetic sequence gives equal
failure lists under both checkers, the pages the port's soaks write parse
under both exposition parsers with equal values and pass both checkers, and
the fleet drill prints the same events and reaches the same end for seeds
0-3.  The checkpoint drill is held to its own checks: the reference's fails
under this container's jax (a ``ShardingTypeError`` at the pipelined gather).

The serving soaks run with every decode step padded to 10 ms, twice the
soak's 5 ms decode target (``decode_over_the_slo``).  The smoke model's
decode takes 1.5-5 ms on a CPU, right at that target, so the serving
controller would shrink or grow at whatever moment the machine's load
pushes a step across it; a first ``grow_batch`` or ``shrink_batch`` that
lands in the last two scrapes is a new timer in the steady tail, and the
check flags it (15% of 4 s soaks failed so under load).  Padded, every step
misses the target: the controller shrinks 4 -> 2 -> 1 in its first polls
and never grows, which is the regime the reference's own CPU soak runs in
(its JAX steps take longer than 5 ms).
"""

from __future__ import annotations

from types import SimpleNamespace

import time

import pytest
import torch

import repro.monitor.promparse as j_promparse
import repro.soak.invariants as j_invariants
from repro.core.timers import PARENT_STATS_CAP as J_PARENT_STATS_CAP
from repro.faults.soak import fleet_drill as jax_fleet_drill
from repro_torch.core.timers import PARENT_STATS_CAP
from repro_torch.faults.soak import checkpoint_drill, fleet_drill
from repro_torch.faults.soak import main as drill_main
from repro_torch.monitor import parse_exposition
from repro_torch.soak import SnapshotRecord, SoakConfig, check_snapshots, run_soak
from repro_torch.soak.run import main as soak_main


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's), and run torch on one
    CPU thread: the smoke model is tiny, and idle-spinning intra-op threads
    would slow the wall-clock soaks that share the machine."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    yield
    reset_default_clocks()
    reset_timer_db()
    reset_param_registry()
    torch.set_num_threads(threads)


DECODE_PAD_S = 0.010  # twice the soak's target_decode_ms


@pytest.fixture
def decode_over_the_slo(monkeypatch):
    """Pad every decode step of the port's model to DECODE_PAD_S (module
    docstring)."""
    from repro_torch.models import model as M

    decode_step = M.decode_step

    def padded(*args, **kwargs):
        t0 = time.perf_counter()
        out = decode_step(*args, **kwargs)
        rest = DECODE_PAD_S - (time.perf_counter() - t0)
        if rest > 0:
            time.sleep(rest)
        return out

    monkeypatch.setattr(M, "decode_step", padded)


def _settled_serving(result) -> None:
    """Every step over the target: two shrinks at the start, never a grow."""
    counts = result.summary["adapt"]["action_counts"]
    assert counts.get("serving::shrink_batch") == 2 and "serving::grow_batch" not in counts


def _both_parse_alike(snapshots) -> None:
    """Each written page parses under both packages' parsers to the same
    samples, and the reference's checker passes the sequence as the port's
    does."""
    ref_records = []
    for snap in snapshots:
        text = open(snap.path, encoding="utf-8").read()
        port_page, ref_page = parse_exposition(text), j_promparse.parse_exposition(text)
        assert port_page.samples == ref_page.samples
        assert port_page.samples == snap.exposition.samples
        ref_records.append(j_invariants.SnapshotRecord(
            index=snap.index, step=snap.step, source=snap.source, actions=dict(snap.actions),
            exposition=ref_page))
    assert j_invariants.check_snapshots(ref_records) == []


# ---------------------------------------------------------------------------
# live smoke: the real drive loop, tiny budget (scrapes /metrics mid-run and
# asserts every ADAPT action appears on the wire)
# ---------------------------------------------------------------------------


def test_train_soak_smoke(tmp_path):
    cfg = SoakConfig(
        mode="train", budget_s=2.0, interval_s=0.25, seed=11,
        fault_rate=0.2, out_dir=str(tmp_path), device="cpu",
    )
    result = run_soak(cfg)
    assert result.failures == []
    assert result.ok
    assert result.steps > 0
    assert len(result.snapshots) >= cfg.min_snapshots
    # the drive provoked real ADAPT decisions, each externally visible
    assert result.summary["adapt"]["n_actions"] > 0
    assert result.summary["faults_injected"] > 0
    # every snapshot was scraped over HTTP and persisted as a parseable page
    for snap in result.snapshots:
        assert snap.source == "http"
        assert snap.parse_error is None
        assert snap.path is not None
        parse_exposition(open(snap.path, encoding="utf-8").read())
    _both_parse_alike(result.snapshots)


def test_train_soak_no_http_render_path():
    result = run_soak(SoakConfig(
        mode="train", budget_s=0.8, interval_s=0.1, seed=3,
        scrape_http=False, device="cpu",
    ))
    assert result.failures == []
    assert all(s.source == "render" for s in result.snapshots)


def test_serve_soak_smoke(tmp_path, decode_over_the_slo):
    cfg = SoakConfig(
        mode="serve", budget_s=4.0, interval_s=0.5, seed=5,
        out_dir=str(tmp_path), device="cpu",
    )
    result = run_soak(cfg)
    assert result.failures == []
    assert result.summary["completed"] > 0
    assert len(result.snapshots) >= cfg.min_snapshots
    assert all(s.parse_error is None for s in result.snapshots)
    assert all(s.source == "http" for s in result.snapshots)
    # every admitted request prefilled once; every engine step with a slot
    # busy decoded once
    summary = result.summary
    assert summary["prefills"] >= summary["completed"] > 0
    assert 0 < summary["decode_steps"] <= result.steps
    assert summary["submitted"] >= summary["completed"] + summary["shed"]
    _settled_serving(result)
    _both_parse_alike(result.snapshots)


def test_serve_soak_render_path_at_the_fields_the_launcher_takes(tmp_path,
                                                                  decode_over_the_slo):
    """``arch``/``attn_impl``/``norm_impl``/``dtype`` reach the engine: the
    smoke model through the kernels' plain versions, in f32."""
    result = run_soak(SoakConfig(
        mode="serve", budget_s=1.5, interval_s=0.25, seed=2, scrape_http=False,
        attn_impl="pallas", norm_impl="fused", dtype="float32", device="cpu",
        out_dir=str(tmp_path),
    ))
    assert result.failures == []
    assert result.summary["completed"] > 0
    assert all(s.source == "render" for s in result.snapshots)
    _settled_serving(result)
    _both_parse_alike(result.snapshots)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown soak mode"):
        run_soak(SoakConfig(mode="bogus", budget_s=0.1))


def test_soak_cli_smoke(tmp_path, capsys):
    rc = soak_main([
        "--mode", "train", "--budget-s", "0.8", "--interval-s", "0.1",
        "--seed", "2", "--out-dir", str(tmp_path), "--no-http", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[soak] ok   train" in out
    assert "all invariants held" in out
    assert list(tmp_path.glob("train_*.prom"))


def test_soak_cli_serve_mode(tmp_path, capsys, decode_over_the_slo):
    rc = soak_main([
        "--mode", "serve", "--budget-s", "1.0", "--interval-s", "0.2", "--seed", "4",
        "--out-dir", str(tmp_path), "--device", "cpu", "--attn-impl", "pallas",
        "--norm-impl", "fused",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "[soak] ok   serve" in out
    assert len(list(tmp_path.glob("serve_*.prom"))) >= 4


# ---------------------------------------------------------------------------
# the fault drills
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fleet_drill_matches_the_reference(seed, capsys):
    """The same failures, evictions, plan adjustments and printed event lines
    as the reference's drill (the simulated fleet computes nothing on a
    device; the control plane decides alike)."""
    got = fleet_drill(seed, 200, device="cpu")
    got_out = capsys.readouterr().out
    want = jax_fleet_drill(seed, 200)
    want_out = capsys.readouterr().out
    assert got == want == []
    assert got_out == want_out
    assert "plan adjustments" in got_out and "[soak] ok   timer set bounded" in got_out


def test_checkpoint_drill_passes_its_own_checks(capsys):
    failures = checkpoint_drill(0, 12, device="cpu")
    out = capsys.readouterr().out
    assert failures == [], out
    assert "resume fell back to newest valid step 9" in out
    assert "['leaf_hash_mismatch', 'stale_tmp']" in out


def test_drill_cli(capsys):
    rc = drill_main(["--seed", "1", "--steps", "120", "--device", "cpu", "--train-steps", "6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[soak] all drills passed" in out
    assert "fleet drill:" in out and "resumed run completed" in out


# ---------------------------------------------------------------------------
# the invariant checker itself: synthetic sequences prove it catches each
# failure class the nightly gate exists for, and the port's checker finds
# exactly what the reference's does
# ---------------------------------------------------------------------------

_BASE = """\
# TYPE repro_scrape_monotonic_seconds gauge
repro_scrape_monotonic_seconds {mono}
# TYPE repro_adapt_actions_total counter
repro_adapt_actions_total{{action="grow",controller="serving"}} {grow}
# TYPE repro_counter_total counter
repro_counter_total{{channel="tokens"}} {tokens}
# TYPE repro_timing_timers gauge
repro_timing_timers {timers}
# TYPE repro_timing_counter_channels gauge
repro_timing_counter_channels 3
# TYPE repro_timing_parent_stats_buckets gauge
repro_timing_parent_stats_buckets {buckets}
# TYPE repro_timing_parent_stats_buckets_max gauge
repro_timing_parent_stats_buckets_max {buckets_max}
# TYPE repro_timing_counter_pending_max gauge
repro_timing_counter_pending_max 0
# TYPE repro_timer_windows_total counter
repro_timer_windows_total{{chain="",path="train"}} {windows}
"""


_Port = SimpleNamespace(SnapshotRecord=SnapshotRecord, parse=parse_exposition)
_Ref = SimpleNamespace(SnapshotRecord=j_invariants.SnapshotRecord,
                       parse=j_promparse.parse_exposition)


def _snap(index, *, mono, grow=1, tokens=10.0, timers=5, buckets=4,
          buckets_max=4, windows=7.0, actions=None, pkg=_Port):
    text = _BASE.format(mono=mono, grow=grow, tokens=tokens, timers=timers,
                        buckets=buckets, buckets_max=buckets_max,
                        windows=windows)
    return pkg.SnapshotRecord(
        index=index, step=index * 100, source="render",
        actions={"serving::grow": grow} if actions is None else actions,
        exposition=pkg.parse(text),
    )


def _clean(pkg):
    return [_snap(i, mono=float(i + 1), tokens=10.0 * (i + 1), pkg=pkg) for i in range(4)]


def _single(pkg):
    return [_snap(0, mono=1.0, pkg=pkg)]


def _parse_error(pkg):
    return [_snap(0, mono=1.0, pkg=pkg),
            pkg.SnapshotRecord(index=1, step=100, source="http", parse_error="line 3: boom")]


def _clock_regression(pkg):
    return [_snap(0, mono=5.0, pkg=pkg), _snap(1, mono=4.0, pkg=pkg)]


def _decreasing_counter(pkg):
    return [_snap(0, mono=1.0, tokens=50.0, pkg=pkg), _snap(1, mono=2.0, tokens=20.0, pkg=pkg)]


def _disappearing_series(pkg):
    text = _BASE.format(mono=2.0, grow=1, tokens=0.0, timers=5, buckets=4,
                        buckets_max=4, windows=7.0)
    text = "\n".join(line for line in text.split("\n") if "channel=\"tokens\"" not in line)
    return [_snap(0, mono=1.0, pkg=pkg),
            pkg.SnapshotRecord(index=1, step=100, source="render",
                               actions={"serving::grow": 1}, exposition=pkg.parse(text))]


def _invisible_action(pkg):
    return [_snap(0, mono=1.0, pkg=pkg),
            _snap(1, mono=2.0, grow=1, actions={"serving::grow": 3}, pkg=pkg)]


def _phantom_action(pkg):
    return [_snap(0, mono=1.0, pkg=pkg), _snap(1, mono=2.0, grow=4, actions={}, pkg=pkg)]


def _bucket_cap(pkg):
    return [_snap(0, mono=1.0, pkg=pkg),
            _snap(1, mono=2.0, buckets_max=PARENT_STATS_CAP + 1, pkg=pkg)]


def _tail_growth(pkg):
    return [_snap(0, mono=1.0, timers=5, pkg=pkg), _snap(1, mono=2.0, timers=5, pkg=pkg),
            _snap(2, mono=3.0, timers=5, pkg=pkg), _snap(3, mono=4.0, timers=9, pkg=pkg)]


def _tail_series(pkg):
    grown = _BASE + 'repro_timer_windows_total{{chain="",path="late"}} 1.0\n'
    return [_snap(0, mono=1.0, pkg=pkg), _snap(1, mono=2.0, pkg=pkg), _snap(2, mono=3.0, pkg=pkg),
            pkg.SnapshotRecord(index=3, step=300, source="render",
                               actions={"serving::grow": 1},
                               exposition=pkg.parse(grown.format(
                                   mono=4.0, grow=1, tokens=10.0, timers=5, buckets=4,
                                   buckets_max=4, windows=7.0)))]


def _everything(pkg):
    """Every failure class at once, over more snapshots than the tail."""
    snaps = [_snap(0, mono=3.0, tokens=40.0, pkg=pkg),
             _snap(1, mono=2.0, tokens=30.0, grow=2, actions={"serving::grow": 1}, pkg=pkg),
             pkg.SnapshotRecord(index=2, step=200, source="http", parse_error="torn"),
             _snap(3, mono=4.0, buckets=5, buckets_max=PARENT_STATS_CAP + 3, pkg=pkg),
             _snap(4, mono=5.0, timers=7, buckets=9, actions={"serving::grow": 1,
                                                              "fleet::join": 1}, pkg=pkg)]
    return snaps


# (sequence, check_snapshots keyword arguments, a fragment each failure list holds)
SEQUENCES = {
    "clean": (_clean, {}, None),
    "single": (_single, {}, ">= 2 snapshots"),
    "parse_error": (_parse_error, {}, "malformed exposition"),
    "clock_regression": (_clock_regression, {}, "monotonic clock went"),
    "decreasing_counter": (_decreasing_counter, {}, "decreased"),
    "disappearing_series": (_disappearing_series, {}, "disappeared"),
    "invisible_action": (_invisible_action, {}, "taken 3x"),
    "phantom_action": (_phantom_action, {}, "never took"),
    "bucket_cap": (_bucket_cap, {}, "exceeds"),
    "tail_growth": (_tail_growth, {"tail_fraction": 0.5}, "grew over the steady tail"),
    "tail_series": (_tail_series, {"tail_fraction": 0.5}, "timer-tree series grew"),
    "everything": (_everything, {"tail_fraction": 0.4}, "fleet::join taken 1x"),
}


def test_checker_passes_clean_sequence():
    assert check_snapshots(_clean(_Port)) == []


def test_checker_needs_two_snapshots():
    failures = check_snapshots(_single(_Port))
    assert any(">= 2 snapshots" in f for f in failures)


def test_checker_flags_parse_errors():
    failures = check_snapshots(_parse_error(_Port))
    assert any("malformed exposition" in f for f in failures)


def test_checker_flags_monotonic_clock_regression():
    failures = check_snapshots(_clock_regression(_Port))
    assert any("monotonic clock went" in f for f in failures)


def test_checker_flags_decreasing_counter():
    failures = check_snapshots(_decreasing_counter(_Port))
    assert any("decreased" in f for f in failures)


def test_checker_flags_disappearing_series():
    failures = check_snapshots(_disappearing_series(_Port))
    assert any("disappeared" in f for f in failures)


def test_checker_flags_invisible_adapt_action():
    # the decision log took 3 actions but the wire shows 1
    failures = check_snapshots(_invisible_action(_Port))
    assert any("taken 3x" in f and "metrics show 1" in f for f in failures)


def test_checker_flags_phantom_adapt_action():
    # the wire reports an action the decision log never took
    failures = check_snapshots(_phantom_action(_Port))
    assert any("never took" in f for f in failures)


def test_checker_flags_bucket_cap_breach():
    failures = check_snapshots(_bucket_cap(_Port))
    assert any("exceeds" in f for f in failures)


def test_checker_flags_tail_cardinality_growth():
    failures = check_snapshots(_tail_growth(_Port), tail_fraction=0.5)
    assert any("grew over the steady tail" in f for f in failures)


def test_checker_flags_tail_series_growth():
    failures = check_snapshots(_tail_series(_Port), tail_fraction=0.5)
    assert any("timer-tree series grew" in f for f in failures)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_checker_matches_the_reference(name):
    build, kwargs, fragment = SEQUENCES[name]
    got = check_snapshots(build(_Port), **kwargs)
    assert got == j_invariants.check_snapshots(build(_Ref), **kwargs)
    if fragment is None:
        assert got == []
    else:
        assert any(fragment in f for f in got), got


def test_caps_match_the_reference():
    from repro.core.clocks import _PENDING_FOLD_CAP as J_PENDING_FOLD_CAP
    from repro_torch.core.clocks import _PENDING_FOLD_CAP

    assert (PARENT_STATS_CAP, _PENDING_FOLD_CAP) == (J_PARENT_STATS_CAP, J_PENDING_FOLD_CAP)
