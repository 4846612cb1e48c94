"""PyTorch port, kill-and-resume: SIGKILL a real CPU training process at a
(seeded) random step, rerun the same command, and hold the resumed loss
trajectory against the port's own uninterrupted run (same seed, fixed LR
horizon) at rtol 1e-5, as ``tests/test_kill_resume.py`` holds the
reference's."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

from repro_torch.faults import seeded_rng

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

_DRIVER = """\
import sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.train import TrainSettings, run_training

ckpt_dir, log_path, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
# ckpt_delay_s throttles the run (~0.35s per synchronous save) so the killer's
# 0.1s poll loop lands the SIGKILL mid-run, with steps still to re-execute
run_training(TrainSettings(
    smoke=True, steps=steps, global_batch=2, seq_len=16, device="cpu",
    attn_impl="pallas", norm_impl="fused",
    ckpt_dir=ckpt_dir, ckpt_mode="fixed", ckpt_every=2, ckpt_synchronous=True,
    ckpt_delay_s=0.35,
    report_every=0, log_path=log_path, lr_total_steps=steps,
))
"""

_STEPS = 10


def _losses(log_path: str) -> dict[int, float]:
    out: dict[int, float] = {}
    with open(log_path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn trailing line from the killed writer
            extra = row.get("extra") or {}
            if "loss" in extra:
                out[row["iteration"]] = extra["loss"]
    return out


def _start(script, ckpt, log, env):
    return subprocess.Popen(
        [sys.executable, script, ckpt, log, str(_STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _run(script, ckpt, log, env) -> str:
    proc = _start(script, ckpt, log, env)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    return out


def test_sigkill_and_resume_trajectory_continuous(tmp_path):
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER)
    env = dict(os.environ, PYTHONPATH=_SRC)
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "train.jsonl")

    # SIGKILL once at least `kill_after` steps are logged — random per the
    # fault-plan RNG so the cut point is not tuned to the checkpoint cadence
    kill_after = seeded_rng(0xFA17, "kill_step").randrange(3, _STEPS - 2)
    proc = _start(str(script), ckpt, log, env)
    deadline = time.monotonic() + 240
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            if os.path.exists(log) and len(_losses(log)) >= kill_after:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.1)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == -signal.SIGKILL, (
        "the run must have died to the SIGKILL, not completed", out)
    killed_losses = _losses(log)
    assert len(killed_losses) >= kill_after, "kill landed before any progress"
    ckpts = [d for d in os.listdir(ckpt) if d.startswith("step_") and not d.endswith(".tmp")]
    assert ckpts, "no checkpoint survived the kill"

    # resume: same command auto-restores from the newest valid checkpoint
    out = _run(str(script), ckpt, log, env)
    m = re.search(r"restored checkpoint at step (\d+)", out)
    assert m, out
    restore_step = int(m.group(1))
    assert restore_step < _STEPS, "kill landed after the final save"
    resumed_losses = _losses(log)
    assert max(resumed_losses) == _STEPS - 1, "resumed run did not reach the end"

    # the port's own uninterrupted run: fresh directory, same seed + horizon
    ref_log = str(tmp_path / "ref.jsonl")
    _run(str(script), str(tmp_path / "ref_ckpt"), ref_log, env)
    ref_losses = _losses(ref_log)
    assert sorted(ref_losses) == list(range(_STEPS))

    # continuity: every step the resumed run executed after the restore
    # point, and every step logged before the kill, matches the
    # uninterrupted trajectory
    after = [i for i in range(restore_step, _STEPS)]
    assert len(after) >= 3
    np.testing.assert_allclose([resumed_losses[i] for i in after],
                               [ref_losses[i] for i in after], rtol=1e-5)
    np.testing.assert_allclose([killed_losses[i] for i in sorted(killed_losses)],
                               [ref_losses[i] for i in sorted(killed_losses)], rtol=1e-5)
