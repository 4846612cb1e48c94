"""PyTorch port, the span recorder of the timer DB: while a ``torch.profiler``
session records, every timer window logs a span (path, parent, host start
and end) and, where CUDA is initialised, a pair of timing events
whose seconds fold into ``<path>/device_s`` at the program's synchronisation
points; otherwise a window records nothing.  The card's events are stood in
for by fakes here; ``portbench/tests/test_portbench_spans.py`` holds the
real ones to CUDA events on the card."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import clocks, timers
from repro_torch.core.clocks import counter_channel, counter_names, resolve_device_events
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as PM
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serving import Request, ServeSession
from repro_torch.timing import TimerDB, TimingSession, scope, span_log, timed

ALL = (0, 2**63 - 1)


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """The port's registries, span log and pending event pairs are
    process-global: each test starts from empty ones, on one CPU thread."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    def fresh():
        reset_default_clocks()
        reset_timer_db()
        reset_param_registry()
        timers._SPAN_LOG.clear()
        clocks._DEVICE_PENDING.clear()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    fresh()
    yield
    fresh()
    torch.set_num_threads(threads)


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


class FakeEvent:
    """A CUDA timing event's surface: ``record``, ``query``, ``elapsed_time``
    (ms); ``at`` is the fake device time it completes at, None until then."""

    def __init__(self):
        self.records, self.at = 0, None

    def record(self, stream):
        assert stream == "stream"
        self.records += 1

    def query(self):
        return self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA counts as initialised on device 0, events are FakeEvents (all made
    listed) and they record on a stand-in stream."""
    made = []

    def new():
        made.append(FakeEvent())
        return made[-1]

    monkeypatch.setattr(clocks, "_cuda_ready", lambda: True)
    monkeypatch.setattr(clocks, "_new_device_event", new)
    monkeypatch.setattr(clocks, "_current_device", lambda: 0)
    monkeypatch.setattr(clocks, "_current_stream", lambda device: "stream")
    clocks._EVENT_POOLS.clear()
    yield made
    clocks._EVENT_POOLS.clear()


def _every_kind_of_window(db):
    """One window of each entry point: handle, start/stop, scope, timed."""
    handle = db.create("outer/by_name")
    with db.scope_handle("outer"):
        db.start(handle)
        db.stop("outer/by_name")
        with db.scope("inner"):
            pass

    @timed("decorated", db=db)
    def work():
        return 1

    work()


def test_without_a_profiler_nothing_is_recorded(fake_card):
    db = TimerDB()
    _every_kind_of_window(db)
    assert db.get("outer").count == 1 and db.get("decorated").count == 1
    assert span_log(*ALL) == [] and fake_card == []
    assert not [n for n in counter_names() if n.endswith("/device_s")]
    assert resolve_device_events() == 0


def test_under_a_profiler_every_window_logs_its_parent():
    db = TimerDB()

    def worker():  # another thread: its own scope stack, so no parent from main
        with db.scope_handle("worker"):
            with db.scope("child"):
                pass

    with _profiling():
        _every_kind_of_window(db)
        with db.scope_handle("outer"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    with db.scope_handle("after"):
        pass
    log = span_log(*ALL)
    assert [(e.path, e.parent) for e in log] == [
        ("outer/by_name", "outer"),
        ("outer/inner", "outer"),
        ("outer", None),
        ("decorated", None),
        ("worker/child", "worker"),
        ("worker", None),
        ("outer", None),
    ]
    assert log[-1].start_ns <= log[4].start_ns <= log[5].end_ns <= log[-1].end_ns
    for e in log:
        assert e.start_ns <= e.end_ns
    outer, inner = log[2], log[1]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert span_log(inner.start_ns, inner.start_ns) == [inner, outer]
    assert span_log(log[-1].end_ns + 1, 2**63 - 1) == []
    # a CPU-only run logs spans but makes no device events
    assert not [n for n in counter_names() if n.endswith("/device_s")]


def test_the_ring_drops_the_oldest_past_its_cap_and_counts_them(monkeypatch):
    from collections import deque

    monkeypatch.setattr(timers, "_SPAN_LOG", deque(maxlen=4))
    db = TimerDB()
    with _profiling():
        for i in range(7):
            with db.scope_handle(f"w{i}"):
                pass
    assert [e.path for e in span_log(*ALL)] == ["w3", "w4", "w5", "w6"]
    assert counter_channel("spans_dropped") == 3.0


def test_resolution_folds_only_completed_pairs(fake_card):
    db = TimerDB()
    with _profiling():
        with db.scope_handle("a"):
            with db.scope("b"):
                pass
        with db.scope_handle("a"):
            pass
    assert len(fake_card) == 6 and all(ev.records == 1 for ev in fake_card)
    # pairs in stop order: a/b (events 1, 2), a (0, 3), a again (4, 5)
    fake_card[1].at, fake_card[2].at = 1.0, 3.5  # a/b done: 2.5 ms
    fake_card[0].at = 0.0  # a's start done, its end still in flight
    fake_card[4].at, fake_card[5].at = 10.0, 11.0  # the second a: 1 ms
    assert resolve_device_events() == 2
    assert counter_channel("a/b/device_s") == pytest.approx(2.5e-3)
    assert counter_channel("a/device_s") == pytest.approx(1e-3)
    assert resolve_device_events() == 0  # the first a waits
    fake_card[3].at = 20.0
    assert resolve_device_events() == 1
    assert counter_channel("a/device_s") == pytest.approx(21e-3)
    assert len(clocks._EVENT_POOLS[0]) == 6  # every folded event back in its pool
    with _profiling():
        with db.scope_handle("a"):
            pass
    assert len(fake_card) == 6  # pooled events are reused


def _tiny_moe_step():
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_opt_state(AdamWConfig(), params)
    built = make_train_step(cfg, ShapeConfig("t", "train", 16, 2))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    return cfg, built, params, opt, batch


def test_the_train_step_and_moe_timers_on_a_tiny_moe_step():
    sess = TimingSession()
    with sess:  # as run_training: the step is built and run in the session
        cfg, built, params, opt, batch = _tiny_moe_step()
        with scope("EVOL"):
            built.fn(params, opt, batch)
        assert span_log(*ALL) == []
        with _profiling():
            with scope("EVOL"):
                built.fn(params, opt, batch)
    names = set(sess.db.names())
    spans = {"train_step/grads", "train_step/optimizer", "model/moe"}
    assert spans <= names
    log = span_log(*ALL)
    assert {e.path for e in log} == spans | {"EVOL"}
    by_path = {e.path: e for e in log}
    assert by_path["train_step/grads"].parent == by_path["train_step/optimizer"].parent == "EVOL"
    assert by_path["train_step/grads"].end_ns <= by_path["train_step/optimizer"].start_ns
    # each layer's forward (and, under remat "dots", what its recompute runs)
    moe = [e for e in log if e.path == "model/moe"]
    assert len(moe) >= cfg.n_layers
    assert sess.db.get("model/moe").count == 2 * len(moe)
    assert all(e.parent == "train_step/grads" for e in moe)


def test_the_prefill_timers_on_a_tiny_prefill():
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(dtype="float32")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sess = TimingSession()
    engine = ServeSession(cfg, params, session=sess, n_slots=2, max_seq=64, device="cpu")
    with sess, _profiling():  # entered: the model's own scopes land in its database
        engine.submit(Request(5, list(range(1, 12)), max_new_tokens=1))
        engine.run_until_idle()
    assert sess.db.get("serve/prefill").count == 1
    log = {e.path: e for e in span_log(*ALL)}
    assert {"serve", "serve/prefill", "model/moe"} <= set(log)
    assert log["serve/prefill"].parent == "serve"
    assert log["model/moe"].parent == "serve/prefill"
    prefill, moe = log["serve/prefill"], log["model/moe"]
    assert prefill.start_ns <= moe.start_ns <= moe.end_ns <= prefill.end_ns
