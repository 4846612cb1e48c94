#!/usr/bin/env python3
"""rwkv6-1.6b's training at full depth (phase 18 trains it cut to 8
layers) under the chunked WKV-6 of this checkout and of another one, in
one process on the card:

    python3 tools/wkv6_memory.py --other DIR/src

``DIR`` holds another checkout (for example the parent commit, unpacked
with ``git archive``).  Its ``repro_torch/kernels/rwkv6/ops.py`` is loaded
beside this checkout's, and ``chip_smoke.py``'s ``_train_phase`` trains
full-width rwkv6-1.6b (24 layers, batch 4 x 1024, remat "dots", 6 AdamW
steps) through ``run_training`` with each ``wkv6_chunked`` in turn: this
checkout's, the other's, this checkout's again.  Each run prints its
losses, its step seconds (median of steps 2-6) and
``max_memory_allocated``.  The chunked form is what training runs
(``seq_impl="parallel"``): the WKV-6 kernel has no backward.  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402


def _other_chunked(src: str):
    """``wkv6_chunked`` of the checkout whose ``src`` is ``src``, loaded as a
    module of this checkout's package (its relative imports resolve here)."""
    path = os.path.join(src, "repro_torch", "kernels", "rwkv6", "ops.py")
    spec = importlib.util.spec_from_file_location("repro_torch.kernels.rwkv6.other_ops", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.wkv6_chunked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, help="the src directory of another checkout")
    args = ap.parse_args(argv)
    import torch

    K = cs._setup(torch)
    this, other = K.wk.wkv6_chunked, _other_chunked(args.other)
    for name, fn in (("this", this), ("other", other), ("this again", this)):
        K.wk.wkv6_chunked = fn
        t0 = time.perf_counter()
        cs._train_phase(torch, K, arch="rwkv6-1.6b", batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
                        tag=f"[wkv6 memory: {name}]")
        cs._free(torch)
        cs._print(f"[wkv6 memory: {name}] {time.perf_counter() - t0:.1f} s")
    K.wk.wkv6_chunked = this
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
