"""Serving launcher of the PyTorch port: continuous-batching inference on the
adapt control plane, on the GPU.

Requests stream through a :class:`repro_torch.serving.ServeSession` — either
all at once (closed-loop drain) or as an open-loop Poisson arrival process
(``--arrival-rate``).  Batch-width and shedding decisions are taken by the
``ADAPT/serving`` controller on the session control loop and render in the
report next to every measured timer.

``--full`` serves the published width of the architecture (default: its smoke
config); ``--attn-impl pallas --norm-impl fused --seq-impl pallas`` select the
hand-written flash-attention, RMSNorm and RG-LRU / WKV-6 kernels (the
reference's names for its kernels).

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --attn-impl pallas --norm-impl fused --prompt-len 512,300 --report
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch rwkv6-1.6b \\
        --attn-impl pallas --norm-impl fused --seq-impl pallas --metrics-textfile serve.prom

``--metrics-textfile`` writes one Prometheus exposition page on exit (the
node_exporter textfile-collector path).
"""

from __future__ import annotations

import argparse
import json
import time
from collections.abc import Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..models import model as M
from ..monitor import MetricsExporter, serving_payload
from ..serving import Request, ServeSession, ServiceLevel
from ..timing import TimingSession

__all__ = ["main", "make_requests", "run_serving"]


def make_requests(
    vocab_size: int,
    n_requests: int,
    prompt_lens: Sequence[int],
    max_new: int,
    rng: np.random.Generator,
) -> list[Request]:
    """``n_requests`` random prompts, their lengths cycling over ``prompt_lens``."""
    requests = []
    for rid in range(n_requests):
        length = prompt_lens[rid % len(prompt_lens)]
        prompt = [int(t) for t in rng.integers(0, vocab_size, length)]
        requests.append(Request(rid, prompt=prompt, max_new_tokens=max_new))
    return requests


def run_serving(
    arch: str = "llama3.2-1b",
    n_requests: int = 16,
    prompt_len: int | Sequence[int] = 32,
    max_new: int = 8,
    *,
    n_slots: int = 8,
    block_size: int = 16,
    target_decode_ms: float | None = None,
    max_queue_delay_s: float | None = None,
    arrival_rate: float | None = None,
    seed: int = 0,
    session: TimingSession | None = None,
    smoke: bool = True,
    attn_impl: str | None = None,
    norm_impl: str | None = None,
    seq_impl: str | None = None,
    dtype: str | None = None,
    device: str | torch.device = "cuda",
) -> ServeSession:
    """Build a :class:`~repro_torch.serving.ServeSession` and serve ``n_requests``.

    ``prompt_len`` is one length or several, cycled over the requests.
    ``attn_impl`` / ``norm_impl`` / ``seq_impl`` / ``dtype`` override the
    config's fields.
    Weights are random, drawn from a generator on ``device`` seeded with
    ``seed``.  With ``arrival_rate`` (requests/second) the submissions follow
    an open-loop Poisson process driven against the wall clock; otherwise
    everything is submitted upfront and drained.  Returns the engine.
    """
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    overrides = {"attn_impl": attn_impl, "norm_impl": norm_impl, "seq_impl": seq_impl,
                 "dtype": dtype}
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, generator, device)
    lens = [prompt_len] if isinstance(prompt_len, int) else list(prompt_len)
    rng = np.random.default_rng(seed)
    engine = ServeSession(
        cfg, params,
        session=session,
        n_slots=n_slots,
        max_seq=max(lens) + max_new + 8,
        block_size=block_size,
        slo=ServiceLevel(
            target_decode_ms=target_decode_ms,
            max_queue_delay_s=max_queue_delay_s,
        ),
        device=device,
    )
    requests = make_requests(cfg.vocab_size, n_requests, lens, max_new, rng)
    if arrival_rate is None:
        for req in requests:
            engine.submit(req)
        engine.run_until_idle()
        return engine

    offsets = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n_requests))
    t0 = time.monotonic()
    pending = list(zip(offsets, requests))
    while pending or engine.queue_depth or engine.active_slots:
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            engine.submit(pending.pop(0)[1])
        engine.step()
        if pending and not engine.queue_depth and not engine.active_slots:
            # idle gap before the next arrival: sleep it off instead of spinning
            time.sleep(max(pending[0][0] - (time.monotonic() - t0), 0.0))
    return engine


def _lengths(text: str) -> list[int]:
    return [int(x) for x in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="serve the published width (default: the smoke config)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=_lengths, default=[32],
                    help="prompt length, or comma-separated lengths cycled over requests")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--target-decode-ms", type=float, default=None)
    ap.add_argument("--max-queue-delay", type=float, default=None,
                    help="SLO: shed queued requests past this estimated wait (s)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrivals (requests/s); default: drain")
    ap.add_argument("--attn-impl", choices=["naive", "chunked", "pallas"], default=None,
                    help="attention implementation; 'pallas' = the CUDA flash kernel")
    ap.add_argument("--norm-impl", choices=["ref", "fused"], default=None,
                    help="rmsnorm implementation; 'fused' = the CUDA RMSNorm kernel")
    ap.add_argument("--seq-impl", choices=["parallel", "ref", "pallas"], default=None,
                    help="rglru/rwkv recurrence in prefill; 'pallas' = the CUDA kernels")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--metrics-textfile", default=None,
                    help="write the final Prometheus exposition here "
                         "(textfile-collector scrape path)")
    args = ap.parse_args(argv)
    sess = TimingSession()
    with sess:
        engine = run_serving(
            args.arch, args.requests, args.prompt_len, args.max_new,
            n_slots=args.slots, block_size=args.block_size,
            target_decode_ms=args.target_decode_ms,
            max_queue_delay_s=args.max_queue_delay,
            arrival_rate=args.arrival_rate,
            session=sess,
            smoke=args.smoke,
            attn_impl=args.attn_impl,
            norm_impl=args.norm_impl,
            seq_impl=args.seq_impl,
            dtype=args.dtype,
            device=args.device,
        )
    print(json.dumps(engine.stats(), indent=1))
    if args.metrics_textfile:
        MetricsExporter(
            sess.db,
            control_loop=engine.control_loop,
            serving_fn=serving_payload(engine),
        ).write_textfile(args.metrics_textfile)
    if args.report:
        print(sess.report())
        print()
        print(sess.tree_report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
