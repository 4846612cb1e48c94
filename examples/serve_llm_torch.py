"""Serving example on the PyTorch port: continuous batching through
ServeSession with every steering/shed decision on the adapt control plane
(paper §3.3), on ``--device`` (the card by default).

    PYTHONPATH=src python examples/serve_llm_torch.py --requests 24 --target-ms 50
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_llm_torch.py --full --attn-impl pallas \
        --norm-impl fused --target-ms 50      # published width, the CUDA kernels

``--attn-impl pallas`` / ``--norm-impl fused`` select the CUDA flash and
RMSNorm kernels (default: the config's own); ``--full`` serves the published
width (default: the smoke config).  Weights are random, drawn from a
generator on the device seeded with 0.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import timing  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import Request, ServeSession, ServiceLevel  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--target-ms", type=float, default=None,
                    help="decode-step latency target; enables ADAPT/serving steering")
    ap.add_argument("--max-queue-delay", type=float, default=None,
                    help="shed queued requests past this estimated wait (s)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published width (default: the smoke config)")
    ap.add_argument("--attn-impl", choices=["naive", "chunked", "pallas"], default=None,
                    help="attention implementation; 'pallas' = the CUDA flash kernel")
    ap.add_argument("--norm-impl", choices=["ref", "fused"], default=None,
                    help="rmsnorm implementation; 'fused' = the CUDA RMSNorm kernel")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, params): the configuration with the impl overrides, and its
    weights drawn on the device from seed 0."""
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    overrides = {"attn_impl": args.attn_impl, "norm_impl": args.norm_impl}
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    device = torch.device(args.device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    return cfg, params


def serve(cfg, params, args: argparse.Namespace, session: timing.TimingSession):
    """Serve ``args.requests`` seeded prompts to completion; returns the
    engine and the request handles."""
    engine = ServeSession(
        cfg, params,
        session=session,
        n_slots=args.slots,
        max_seq=args.prompt_len + args.max_new + 8,
        slo=ServiceLevel(target_decode_ms=args.target_ms,
                         max_queue_delay_s=args.max_queue_delay),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    handles = [
        engine.submit(Request(
            rid, prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, args.prompt_len)],
            max_new_tokens=args.max_new,
        ))
        for rid in range(args.requests)
    ]
    engine.run_until_idle()
    return engine, handles


def report(engine: ServeSession, handles, sess: timing.TimingSession) -> None:
    print(f"done: {sum(h.done for h in handles)}/{len(handles)} handles resolved")
    print(json.dumps(engine.stats(), indent=1))
    print(sess.report())
    print()
    print(sess.tree_report())


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, params = build(args)
    with timing.session() as sess:
        engine, handles = serve(cfg, params, args, sess)
        report(engine, handles, sess)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
