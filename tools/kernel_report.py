#!/usr/bin/env python3
"""What ``nvcc`` makes of the port's CUDA kernels, on a machine with the CUDA
toolkit:

    python3 tools/kernel_report.py [SOURCE ...]

Compiles each ``src/repro_torch/kernels/csrc/<SOURCE>.cu`` (all of them by
default) with the build's flags plus ``-Xptxas -v`` into ``build/report/``,
one ``nvcc`` per source, all started together, and prints one line per
kernel: its registers a thread, spill stores and loads in bytes, static
shared memory in bytes (the dynamic shared memory a launch asks for is the
source's and ``chip_smoke.py``'s to print), and how many ``HGMMA`` (wgmma)
and ``UTMALDG`` (TMA tile load) instructions its SASS holds (``cuobjdump
-sass``).  Exits non-zero if a source does not
compile or a tensor-core kernel (``*_tc_kernel``, and ``*_wg_kernel``: the
dkv kernel whose warpgroups split dK and dV) lacks either
instruction.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "report"


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def _demangle(names: list[str]) -> list[str]:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.split("\n")
    return out[: len(names)]


def _ptxas(log: str) -> dict[str, list[int]]:
    """mangled kernel name -> [registers, spill store bytes, spill load
    bytes, static shared memory bytes]"""
    stats: dict[str, list[int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for", line)
        if m:
            name = m.group(1)
            stats[name] = [0, 0, 0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            stats[name][1:3] = [int(m.group(1)), int(m.group(2))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            stats[name][0] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                stats[name][3] = int(m.group(1))
    return stats


def _sass(lib: Path) -> dict[str, list[int]]:
    """mangled kernel name -> [HGMMA count, UTMALDG count]"""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, list[int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UTMALDG" in line
    return counts


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build  # the build's flags and sources

    sources = sys.argv[1:] or list(build.SOURCES)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [_tool("nvcc"), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(OUT / f"{name}.so"),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in sources
    }
    ok = True
    for source, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc {source}.cu failed ({proc.returncode}):\n{log}", flush=True)
            ok = False
            continue
        stats, sass = _ptxas(log), _sass(OUT / f"{source}.so")
        mangled = sorted(stats)
        for name, pretty in zip(mangled, _demangle(mangled)):
            regs, st, ld, smem = stats[name]
            hgmma, utmaldg = sass.get(name, [0, 0])
            tensor_core = "_tc_kernel" in pretty or "_wg_kernel" in pretty
            ok &= not tensor_core or (hgmma > 0 and utmaldg > 0)
            print(f"[{source}] {pretty[:110]}: registers={regs} spill_stores={st} "
                  f"spill_loads={ld} static_smem={smem} HGMMA={hgmma} UTMALDG={utmaldg}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
