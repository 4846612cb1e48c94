#!/usr/bin/env python3
"""The dry run's records as one markdown table:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    python3 tools/dryrun_table.py [DIR]

One row an (arch, mesh) of ``DIR`` (default ``artifacts/dryrun``), one
column a shape; a cell gives, for one device, the state bytes (params,
optimizer state, cache) in GB, a "!" where they pass the H100's 80 GB
(``CARD_GB``), the peak of live local bytes in GB, the local matmul FLOPs
and the collective operand bytes in GB; a skipped cell "skip", a failed
one "FAIL".  Every number is one device's, from an analysis on a fake
process group (``repro_torch.launch.dryrun``): no card ran it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
MESH_ORDER = {"single": 0, "multi": 1}
#: the memory of the port's card, the H100 80 GB, in GB
CARD_GB = 80.0


def _cell(r) -> str:
    if r is None:
        return "—"
    if r["status"] != "ok":
        return "skip" if r["status"] == "skipped" else "FAIL"
    state = sum(r["state_bytes"].values()) / 1e9
    peak = r["memory_analysis"]["peak_bytes"] / 1e9
    moved = sum(r["collective_operand_bytes_per_device"].values()) / 1e9
    flag = "!" if state > CARD_GB else ""
    return (f"{state:.2f}{flag} / {peak:.2f} GB, {r['cost_analysis']['flops']:.2e}, "
            f"{moved:.2f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dir", nargs="?", default=os.path.join("artifacts", "dryrun"))
    args = ap.parse_args(argv)
    records = {}
    for path in glob.glob(os.path.join(args.dir, "*.json")):
        r = json.load(open(path))
        records[(r["mesh"], r["arch"], r["shape"])] = r
    shapes = sorted({k[2] for k in records}, key=lambda s: SHAPE_ORDER.get(s, 9))
    rows = sorted({k[:2] for k in records}, key=lambda k: (MESH_ORDER.get(k[0], 9), k[1]))
    print("| mesh | arch | " + " | ".join(shapes) + " |")
    print("| --- | --- | " + " | ".join("---" for _ in shapes) + " |")
    for mesh, arch in rows:
        cells = [_cell(records.get((mesh, arch, s))) for s in shapes]
        print(f"| {mesh} | {arch} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
