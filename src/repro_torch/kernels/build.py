"""Build and load the port's hand-written CUDA kernels, and dispatch by device.

Counterpart of the reference's ``kernels/common.py``.  There, a kernel runs
compiled on a TPU and in Pallas interpret mode elsewhere; here the rule is the
tensor's device:

* tensors on the CPU take the kernel's plain PyTorch version (the tests);
* tensors on a CUDA device launch the kernel, or raise — there is no fallback.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by its own ``nvcc`` process (all sources at once, in parallel) into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the checkout,
then loaded with :mod:`ctypes`.  The hash covers the source, every
``csrc/*.cuh`` header it includes (``#include "name.cuh"``, followed into
headers that include others) and the flags, so an edited kernel or helper
header is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "check", "library", "on_cuda"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "rglru", "rwkv6")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path] | None = None) -> list[Path]:
    """``path`` and every local header it includes, each once, in order."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                _sources(header, seen)
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel source that has no up-to-date library yet, one
    ``nvcc`` per source, all started together; load them all.  Returns the
    wall seconds spent.  Raises with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS and not _target(n).exists()]
        if todo:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for name in todo:
                out = _target(name)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )))
            failures = []
            for name, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, out)
            if failures:
                raise RuntimeError("\n".join(failures))
        for name in SOURCES:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (builds on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; anything else (mixed, or another device) raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, got {sorted(kinds)}")
