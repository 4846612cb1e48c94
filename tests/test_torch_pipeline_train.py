"""PyTorch port, the training launcher's 1F1B pipeline path on the CPU
(``repro_torch.launch.train`` with ``pipeline_stages``): the residual-MLP
stack learns and times its three phases on 1 and 2 CPU ranks,
``--pipeline-model`` trains the architecture's transformer, the topology is
stamped into every checkpoint and a 4 -> 2 stage restore re-apportions the
saved stage weights, a slow stage owner is answered by a restage that the
next step runs, and a card mesh the machine cannot hold raises.
"""

import json
import os

import pytest
import torch

from repro_torch.adapt import ControlLoop, StragglerResponse
from repro_torch.checkpoint import load_checkpoint
from repro_torch.core import TimerLogger
from repro_torch.core.timers import TimerDB
from repro_torch.dist.meshutil import local_mesh
from repro_torch.dist.pipeline import MicrobatchPlan, PipelineStep, StagePlan
from repro_torch.dist.stragglers import LocalTransport, StragglerDetector
from repro_torch.fleet import stage_for_host
from repro_torch.launch import train as T
from repro_torch.launch.steps import make_pipeline_train_step
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.timing import TimingSession

PHASES = ("warmup", "steady", "cooldown")


@pytest.fixture(autouse=True)
def _fresh_port_infra():
    """Isolate the port's own process-global timer/clock/param registries
    (``tests/conftest.py`` resets only the reference's), and run torch on one
    CPU thread."""
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


def _mlp_settings(**kw):
    base = dict(device="cpu", steps=12, global_batch=8, seq_len=16, ckpt_dir=None,
                ckpt_mode="off", report_every=0, pipeline_stages=1, pipeline_layers=4,
                pipeline_micro=4, pipeline_width=16, peak_lr=1e-2)
    return T.TrainSettings(**{**base, **kw})


def _timer_names(rows):
    names = set()
    for r in rows:
        names.add(r["timer"])
        names |= _timer_names(r.get("children", []))
    return names


@pytest.mark.parametrize("n_stages", [1, 2])
def test_mlp_pipeline_learns_and_times_phases(tmp_path, n_stages):
    log = str(tmp_path / "train.jsonl")
    settings = _mlp_settings(pipeline_stages=n_stages, log_path=log)
    sess = TimingSession(TimerDB())
    summary = T.run_training(settings, session=sess)
    assert summary["iterations"] == settings.steps
    losses = [r["extra"]["loss"] for r in TimerLogger(log, sess.db).read_all()]
    assert len(losses) == settings.steps and all(x == x for x in losses)
    assert losses[-1] < 0.9 * losses[0], losses   # the stage stack learns
    pipe = summary["pipeline"]
    assert pipe["n_stages"] == n_stages and pipe["workload"] == "mlp"
    assert pipe["n_layers"] == 4 and pipe["n_micro"] == 4
    assert pipe["depths"] == StagePlan.equal(range(n_stages), 4).depths()
    for phase in PHASES:
        assert sess.db.get(f"train/pipeline/{phase}").count == settings.steps
        assert pipe["phase_seconds"][phase] > 0.0
    assert {f"train/pipeline/{p}" for p in PHASES} <= _timer_names(summary["timer_tree"])
    # the MLP path counts the stack's own matmul parameters, 6 N D a step
    channels = sess.db.get("EVOL/trainer::train_step").read_flat()
    assert channels["tokens"] == settings.steps * 8 * 16
    assert channels["xla_flops"] == pytest.approx(settings.steps * 6.0 * 4 * 2 * 16 ** 2 * 8 * 16)


def test_pipeline_model_cli_trains_the_transformer(capsys):
    assert T.main(["--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32",
                   "--pipeline-stages", "2", "--pipeline-micro", "2", "--pipeline-model",
                   "--attn-impl", "pallas", "--norm-impl", "fused",
                   "--ckpt-mode", "off"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    pipe = summary["pipeline"]
    assert pipe["workload"] == "llama3.2-1b-smoke" and pipe["n_stages"] == 2
    assert pipe["n_layers"] == 2 and pipe["depths"] == {"0": 1, "1": 1}
    assert all(pipe["phase_seconds"][p] > 0.0 for p in PHASES)
    loss = summary["final_metrics"]["loss"]
    assert loss == loss and loss > 0.0


class _Operator:
    """Derates one stage's weight before the first step (what a restage
    leaves behind), so the stamped topology is not the equal split."""

    name = "operator"
    channels = ()

    def __init__(self, loop, stage, weight):
        self.loop, self.stage, self.weight = loop, stage, weight

    def control(self, step, measurements):
        if step == 0:
            self.loop.controller("stragglers").stage_plan.set_weight(self.stage, self.weight)
        return []


def test_topology_stamped_and_four_to_two_stage_restore_reapportions(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sess = TimingSession(TimerDB())
    sess.control_loop.register(_Operator(sess.control_loop, 1, 0.5))
    first = T.run_training(_mlp_settings(steps=4, pipeline_stages=4, pipeline_layers=8,
                                         ckpt_dir=ckpt, ckpt_mode="fixed", ckpt_every=2),
                           session=sess)
    assert first["pipeline"]["depths"] == {0: 2, 1: 2, 2: 2, 3: 2}
    saved = sorted(n for n in os.listdir(ckpt) if n.startswith("step_") and "." not in n)
    assert saved
    for name in saved:
        _, tree, meta = load_checkpoint(os.path.join(ckpt, name))
        assert meta["topology"] == {"n_layers": 8, "n_micro": 4, "stage_weights": {
            "0": 1.0, "1": 0.5, "2": 1.0, "3": 1.0}}
        assert tuple(tree["params"]["layers"].shape) == (8, 2, 16, 16)
    # resume onto 2 stages: the survivors keep their weights, and the same
    # 8 layers split along the new boundaries
    sess = TimingSession(TimerDB())
    second = T.run_training(_mlp_settings(steps=6, pipeline_stages=2, pipeline_layers=8,
                                          ckpt_dir=ckpt, ckpt_mode="off"), session=sess)
    assert second["resume"]["selected_step"] == 4
    assert second["iterations"] == 6
    assert StagePlan(n_layers=8, weights={0: 1.0, 1: 0.5}).depths() == {0: 5, 1: 3}
    assert second["pipeline"]["depths"] == {0: 5, 1: 3}
    assert sess.db.get("train/pipeline/steady").count == 2
    loss = second["final_metrics"]["loss"]
    assert loss == loss


def test_slow_stage_owner_is_restaged_and_the_next_step_runs_the_new_split(monkeypatch):
    """Two hosts own the two stages of the launcher's MLP pipeline step
    (``fleet.stage_for_host``); host 1 runs 2.5x slow.  The straggler
    response moves the stage boundary (``restage``), and the very next
    step packs the new split: its stage mask is the new plan's."""
    masks = []
    call = PipelineStep.__call__

    def spy(self, stage_params, x, targets, stage_mask=None, **kw):
        masks.append(stage_mask.tolist())
        return call(self, stage_params, x, targets, stage_mask, **kw)

    monkeypatch.setattr(PipelineStep, "__call__", spy)
    n_micro, n_layers = 4, 8
    db = TimerDB()
    transport = LocalTransport()
    detector = StragglerDetector(2, window=2, threshold=1.3, transport=transport,
                                 publish=False, db=db)
    stage_plan = StagePlan.equal(range(2), n_layers)
    owners = stage_for_host([0, 1], 2)
    assert owners == {0: 0, 1: 1}
    loop = ControlLoop(db)
    loop.register(StragglerResponse(detector, MicrobatchPlan.equal([0, 1], n_micro),
                                    evict_after=8, stage_plan=stage_plan,
                                    stage_for_host=owners))
    built = make_pipeline_train_step(local_mesh((2,), ("pod",), device="cpu"), stage_plan,
                                     width=8, vocab_size=32, seq_len=8, global_batch=8,
                                     n_micro=n_micro, device="cpu")
    params = built.init_params()
    opt_state = init_opt_state(AdamWConfig(), params)
    gen = torch.Generator().manual_seed(0)
    restaged_at = None
    for step in range(6):
        batch = {k: torch.randint(0, 32, (8, 8), generator=gen) for k in ("tokens", "targets")}
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        assert torch.isfinite(metrics["loss"])
        depths = stage_plan.depths()
        for host, stage in owners.items():
            transport.publish(host, (2.5 if host == 1 else 1.0) * depths[stage] * n_micro)
        if [a for a in loop.poll(step) if a.action == "restage"] and restaged_at is None:
            restaged_at = step
            new_mask = stage_plan.pack(torch.zeros(n_layers))[1].tolist()
    assert restaged_at is not None
    assert stage_plan.depths()[1] < n_layers // 2
    before = StagePlan.equal(range(2), n_layers).pack(torch.zeros(n_layers))[1].tolist()
    assert masks[:restaged_at + 1] == [before] * (restaged_at + 1)
    assert masks[restaged_at + 1] == new_mask != before


def test_pipeline_stages_beyond_the_visible_cards_raise():
    visible = torch.cuda.device_count()
    n = max(2, visible + 1)
    settings = T.TrainSettings(device="cuda", steps=1, pipeline_stages=n)
    with pytest.raises(ValueError, match=f"needs {n} devices but only {visible} are visible"):
        T.run_training(settings, session=TimingSession(TimerDB()))
