"""End-to-end training on the PyTorch port: train a ~100M-parameter LM with the
full framework — scheduler bins, timer database, AdaptCheck-steered
checkpointing, async writer, restartability, straggler detector, timing
report — on ``--device`` (the card by default).

Default config is a ~100M llama-style model on the copy task (loss visibly
drops as induction forms):

    PYTHONPATH=src python examples/train_llm_torch.py --steps 300 \
        --attn-impl pallas --norm-impl fused       # the CUDA kernels

``--fast`` scales to a ~20M model / smaller batch with identical code paths;
``--device cpu`` runs on the host (the kernels' plain versions).
``--attn-impl pallas`` / ``--norm-impl fused`` select the CUDA flash and
RMSNorm kernels (default: the config's own).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch import timing  # noqa: E402
from repro_torch.launch.train import TrainSettings, run_training  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402


def model_100m() -> ArchConfig:
    return ArchConfig(
        name="demo-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=5, d_ff=2560, vocab_size=16384,
        rope_theta=10000.0, attn_chunk=128,
    )


def model_20m() -> ArchConfig:
    return ArchConfig(
        name="demo-20m", family="dense", n_layers=6, d_model=320,
        n_heads=5, n_kv_heads=5, d_ff=1280, vocab_size=8192,
        rope_theta=10000.0, attn_chunk=128,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fast", action="store_true", help="~20M model, small batch")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "train_llm_ckpt"))
    ap.add_argument("--monitor-port", type=int, default=None)
    ap.add_argument("--attn-impl", choices=["naive", "chunked", "pallas"], default=None,
                    help="attention implementation; 'pallas' = the CUDA flash kernel")
    ap.add_argument("--norm-impl", choices=["ref", "fused"], default=None,
                    help="rmsnorm implementation; 'fused' = the CUDA RMSNorm kernel")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def settings_for(args: argparse.Namespace) -> tuple[ArchConfig, TrainSettings]:
    cfg = model_20m() if args.fast else model_100m()
    batch = args.batch or (4 if args.fast else 8)
    seq = args.seq or (128 if args.fast else 256)
    settings = TrainSettings(
        arch=cfg.name, steps=args.steps, global_batch=batch, seq_len=seq,
        peak_lr=3e-3, ckpt_dir=args.ckpt_dir, ckpt_mode="adaptive",
        ckpt_max_fraction=0.05, ckpt_max_interval_s=120.0,
        report_every=20, data_mode="copy", monitor_port=args.monitor_port,
        log_path=args.ckpt_dir + "/timers.jsonl", device=args.device,
        attn_impl=args.attn_impl, norm_impl=args.norm_impl,
    )
    return cfg, settings


def train(argv=None) -> tuple[dict, timing.TimingSession]:
    """Parse ``argv``, train, print the summary and both reports; returns
    the summary and the session."""
    cfg, settings = settings_for(parse_args(argv))
    sess = timing.TimingSession(timing.timer_db())
    summary = run_training(settings, cfg=cfg, session=sess)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("bin_seconds", "timer_tree")},
                     indent=1, default=str))
    print(sess.report(channels=("walltime", "cputime", "xla_flops")))
    print()
    print(sess.tree_report())
    return summary, sess


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
