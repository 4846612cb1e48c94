"""Fused RMSNorm over the last axis: the CUDA kernel on the card, its plain
PyTorch version on the CPU.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``rmsnorm_fwd`` of ``src/repro/kernels/rmsnorm/kernel.py``.  It is memory
bound on the H100 (one read and one write of each row, ~4 flop per element);
its design — one warp per row, 16-byte vector accesses, an f32 shuffle
reduction — aims at full-width memory transactions and nothing else.
``launches`` counts the kernel's launches (never the plain version's calls).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["rms_norm_fused", "rms_norm_plain"]

#: kernel launches since the counter was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 mean of squares,
    ``x * rsqrt(var + eps) * w`` in f32, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _kernel():
    fn = build.library("rmsnorm").rmsnorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last axis; any leading shape."""
    if not build.on_cuda(x, w):
        return rms_norm_plain(x, w, eps)
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and w of one dtype, got {x.dtype}/{w.dtype}")
    if w.shape != (d,) or not w.is_contiguous() or x2d.stride() != (d, 1):
        raise ValueError(f"rmsnorm kernel needs row-major x (..., {d}) and contiguous w ({d},)")
    y = torch.empty_like(x2d)
    if x2d.shape[0] == 0:
        return y.reshape(x.shape)
    err = _kernel()(
        x2d.data_ptr(), w.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], x2d.shape[0], d,
        eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm_fwd")
    global launches
    launches += 1
    return y.reshape(x.shape)
