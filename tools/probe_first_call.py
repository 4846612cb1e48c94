#!/usr/bin/env python3
"""Where the first pipelined call of fresh pipeline processes spends its
time:

    python3 tools/probe_first_call.py [--world 4] [--calls 3]

Spawns ``--world`` processes sharing ``cuda:0`` (gloo, each capped as
``chip_smoke.py``'s phase 29 caps them), builds phase 29's pipelined step
(full-width llama3.2-1b, 16 units over the processes, 8 microbatches of
1 x 1024, the kernel path) on each and times ``--calls`` loss-and-gradient
calls.  For the first two calls it logs every point-to-point exchange of
rank 0 and rank 1 (start and length in seconds, the peers sent to and
received from); during the first it samples rank 0's and rank 1's main
thread every 20 ms and prints the innermost frames where the samples fell
(and, inside an import, the frames that started it).  A wait in an
exchange is a wait on the neighbours' ticks: a cost one rank pays alone on
the first call shows up on every rank, added up along the pipeline.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402

SAMPLE_S = 0.02


def _where(frame) -> str:
    """The innermost frames of a sample; inside an import, the importer's."""
    stack = traceback.extract_stack(frame)
    name = lambda f: f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"  # noqa: E731
    first_import = next((j for j, f in enumerate(stack) if "importlib" in f.filename), None)
    inner = " <- ".join(name(f) for f in reversed(stack[-3:]))
    if first_import:
        return inner + "  || imported by " + " <- ".join(
            name(f) for f in reversed(stack[max(0, first_import - 3):first_import]))
    return inner


def _rank(rank, world, n_calls):
    import torch
    import torch.distributed as dist

    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist import p2p
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.launch.steps import make_transformer_pipeline_train_step

    cs._procs_kernels(cs.PROCS_MEMORY_FRACTION)
    mesh = device_mesh((world,), ("pod",), "cuda", allow_shared_card=True)
    cfg = cs._train_cfg("llama3.2-1b")
    built = make_transformer_pipeline_train_step(
        cfg, mesh, StagePlan.equal(range(world), cfg.n_layers), seq_len=cs.TRAIN_SEQ,
        global_batch=cs.PIPE_RANK_BATCH, n_micro=cs.PIPE_RANK_MICRO, seed=cs.SEED,
        device="cuda")
    params = built.init_params()
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, cs.TRAIN_SEQ, cs.PIPE_RANK_BATCH,
                                       mode="copy", seed=cs.SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}
    exchange = p2p.Transport.exchange
    main = threading.get_ident()
    out = {"seconds": [], "exchanges": [], "samples": None}
    for i in range(n_calls):
        log, samples, stop = [], collections.Counter(), threading.Event()

        def logged(self, sends, recvs, **kw):
            a = time.perf_counter()
            got = exchange(self, sends, recvs, **kw)
            log.append((round(a - t0, 3), round(time.perf_counter() - a, 3),
                        [s[0] for s in sends], [r[0] for r in recvs]))
            return got

        def sample():
            while not stop.wait(SAMPLE_S):
                frame = sys._current_frames().get(main)
                if frame is not None:
                    samples[_where(frame)] += 1

        sampler = threading.Thread(target=sample, daemon=True)
        p2p.Transport.exchange = logged
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0:
            sampler.start()
        built.pipeline_call(params, batch)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        p2p.Transport.exchange = exchange
        if i == 0:
            stop.set()
            sampler.join()
            out["samples"] = samples.most_common(20)
        if i < 2:
            out["exchanges"].append(log)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()

    import torch

    from repro_torch.dist.spawn import run_ranks
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs._smi())
    build.build_all()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cs.DIST_ALLOC_CONF
    ranks = run_ranks(_rank, args.world, args.calls, device="cuda")
    for r, out in enumerate(ranks):
        print(f"rank {r}: call seconds {[round(s, 4) for s in out['seconds']]}")
    for r in (0, 1):
        for i, log in enumerate(ranks[r]["exchanges"]):
            print(f"rank {r}, call {i + 1}: exchanges (start s, seconds, to, from) {log}")
        print(f"rank {r}, call 1: where the main thread was ({SAMPLE_S * 1e3:.0f} ms samples)")
        for where, n in ranks[r]["samples"]:
            print(f"  {n * SAMPLE_S:7.2f} s  {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
