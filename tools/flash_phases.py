#!/usr/bin/env python3
"""Where a warpgroup of the bf16 ``flash_fwd`` kernel spends its cycles, on
one NVIDIA card:

    python3 tools/flash_phases.py [--only REGEX] [--calls N]

Builds the kernels with ``-DFLASH_FWD_PHASES`` (their own libraries beside
the plain build's), whose forward kernel adds the SM cycles (``clock64``)
of each phase of a block to one counter per warpgroup: the prologue, the
wait for Q, the first step, then per main-loop step the wait for K/V, the
issue of S = Q K^T and of O += P V, the wait for S, the softmax, the wait
for P V and the rescale, then the last step and the epilogue.  Each case of
``tools/time_flash.py``'s ``FWD_PATH_CASES`` (or those whose name matches
``--only``) runs ``--calls`` times after a 256 MB write that evicts the L2,
and the script prints, per warpgroup, the mean cycles of each phase a block
and of each main-loop phase a step, and the instrumented calls' median
time (the counters themselves cost a few percent).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("prologue", "q_wait", "first_step", "data_wait", "issue_s", "issue_pv", "s_wait",
          "softmax", "pv_wait", "rescale", "last_step", "epilogue")
STEP_PHASES = PHASES[3:10]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="cases whose name matches this expression")
    parser.add_argument("--calls", type=int, default=5, help="counted calls a case")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from time_flash import FWD_PATH_CASES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-DFLASH_FWD_PHASES")
    read = build.library("flash_attention").flash_fwd_phases
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    width = len(PHASES) + 2
    counters = (ctypes.c_ulonglong * (2 * width))()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device="cuda")
    for name, (b, s, h, kv, hd, causal, window) in FWD_PATH_CASES.items():
        if not re.search(args.only, name):
            continue
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        build.check(read(ctypes.addressof(counters), 1), "flash_fwd_phases")
        events = []
        for _ in range(args.calls):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        build.check(read(ctypes.addressof(counters), 1), "flash_fwd_phases")
        ms = sorted(a.elapsed_time(z) for a, z in events)[len(events) // 2]
        for wg in range(2):
            row = counters[wg * width:(wg + 1) * width]
            blocks, steps = row[-2], row[-1]
            if blocks == 0:
                continue
            per_block = {p: round(row[i] / blocks) for i, p in enumerate(PHASES)}
            per_step = {p: round(row[PHASES.index(p)] / max(steps, 1)) for p in STEP_PHASES}
            print(f"[phases] {name} ms={ms:.5f} warpgroup={wg} blocks={blocks} "
                  f"steps/block={steps / blocks:.2f} cycles/block={sum(row[:-2]) / blocks:.0f} "
                  f"per_block={per_block} per_step={per_step}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
