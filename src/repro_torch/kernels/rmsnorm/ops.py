"""Fused RMSNorm over the last axis, forward and backward: the CUDA kernels on
the card, their plain PyTorch versions on the CPU, and the
``autograd.Function`` that joins them.

The kernels replace the Pallas TPU kernels ``rmsnorm_fwd``
(``csrc/rmsnorm.cu``) and ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``) of
``src/repro/kernels/rmsnorm/kernel.py``.  Both are memory bound on the H100
(one read of each input row, one write of each output row, ~4-10 flop per
element); their design — a group of 8 to 32 lanes per row, 16-byte vector
accesses, f32 shuffle reductions — aims at full-width memory transactions.
The forward keeps each row in registers between its sum of squares and the
store (rows of up to 4096 bf16 or 2048 f32 elements; narrow rows several to
a warp; wider rows take a looped kernel), in one launch.  The backward
keeps each row in registers between its two sums and the dx write (rows of
up to 2048 bf16 or 1024 f32 elements; wider rows take a looped kernel) and
forms dw in two stages (per-block f32 partial sums, then a hand-written
column reduction in a fixed order), so it is deterministic.

``rms_norm_fused`` goes through :class:`RMSNormFused` on both devices: any
leading shape, reshaped to (N, D); the backward casts the f32 dw to w's
dtype, as the reference's ``ops.py`` does.  ``launches`` and
``bwd_launches`` count kernel launches (never the plain versions' calls).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = [
    "RMSNormFused",
    "bwd_kernel_info",
    "fwd_kernel_info",
    "rms_norm_bwd",
    "rms_norm_bwd_plain",
    "rms_norm_fused",
    "rms_norm_fwd",
    "rms_norm_plain",
]

#: rmsnorm_fwd kernel launches since the counter was last set to 0
launches = 0
#: rmsnorm_bwd kernel launches since the counter was last set to 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: warps per block of the backward kernel; each keeps a (D,) f32 slot of dw
#: in shared memory, which one block may use up to 227 KB of on an H100
_BWD_WARPS = 8
_SMEM_LIMIT = 232_448
#: the backward kernel's blocks per SM at most, each writing one (D,) row of
#: f32 dw partial sums (the kernel picks its grid from the card's occupancy)
_BWD_BLOCKS_PER_SM = 4


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 mean of squares,
    ``x * rsqrt(var + eps) * w`` in f32, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rms_norm_bwd_plain(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch, f32 inside:
    ``dx = (dy·w − x̂·mean(dy·w·x̂))·r`` in x's dtype and ``dw = Σ dy·x̂`` in
    f32, for x, dy (N, D) and w (D,)."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dxhat = dyf * w.float()
    inner = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (dxhat - xhat * inner) * r
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0)


def _fwd_kernel():
    fn = build.library("rmsnorm").rmsnorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _bwd_kernel():
    fn = build.library("rmsnorm_bwd").rmsnorm_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i, ctypes.c_longlong, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _bwd_max_blocks(x: torch.Tensor) -> int:
    return _BWD_BLOCKS_PER_SM * torch.cuda.get_device_properties(x.device).multi_processor_count


def _check_rows(x2d: torch.Tensor, w: torch.Tensor, *more: torch.Tensor) -> None:
    d = x2d.shape[-1]
    if x2d.dtype not in _DTYPES or any(t.dtype != x2d.dtype for t in (w, *more)):
        raise TypeError("rmsnorm kernels take f32/bf16 tensors of one dtype, got "
                        + "/".join(str(t.dtype) for t in (x2d, w, *more)))
    if w.shape != (d,) or not w.is_contiguous() or any(
        t.stride() != (d, 1) or t.shape != x2d.shape for t in (x2d, *more)
    ):
        raise ValueError(f"rmsnorm kernels need row-major (N, {d}) rows and contiguous w ({d},)")


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape: the forward kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(x, w, kernel="rmsnorm_fwd"):
        return rms_norm_plain(x, w, eps)
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    _check_rows(x2d, w)
    y = torch.empty_like(x2d)
    if x2d.shape[0] == 0:
        return y.reshape(x.shape)
    err = _fwd_kernel()(
        x2d.data_ptr(), w.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], x2d.shape[0], d,
        eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm_fwd")
    global launches
    launches += 1
    return y.reshape(x.shape)


def rms_norm_bwd(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw f32) for x, dy (N, D) and w (D,): the backward
    kernel on CUDA tensors, its plain version on CPU tensors."""
    if not build.on_cuda(x, w, dy, kernel="rmsnorm_bwd"):
        return rms_norm_bwd_plain(x, w, dy, eps)
    _check_rows(x, w, dy)
    n, d = x.shape
    if _BWD_WARPS * d * 4 > _SMEM_LIMIT:
        raise ValueError(f"rmsnorm_bwd kernel: D = {d} is too wide for its shared-memory dw slices")
    dx = torch.empty_like(x)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dw.zero_()
    max_blocks = _bwd_max_blocks(x)
    partial = torch.empty((max_blocks, d), dtype=torch.float32, device=x.device)
    err = _bwd_kernel()(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), _DTYPES[x.dtype], n, d, eps, max_blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, dw


def fwd_kernel_info(x: torch.Tensor, w: torch.Tensor) -> dict[str, int]:
    """What ``rms_norm_fwd`` launches for these CUDA rows (N, D): registers
    and local (spill) bytes a thread, threads a block, blocks, and launches
    (always 1); builds the kernels on first use."""
    _check_rows(x, w)
    fn = build.library("rmsnorm").rmsnorm_fwd_info
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, ctypes.c_longlong, i, p]
    fn.restype = i
    out = (ctypes.c_int * 4)()
    n, d = x.shape
    # y is allocated like x, so its alignment is x's
    build.check(fn(x.data_ptr(), w.data_ptr(), x.data_ptr(), _DTYPES[x.dtype], n, d,
                   ctypes.addressof(out)), "rmsnorm_fwd_info")
    return dict(zip(("registers", "local_bytes", "threads", "blocks"), out), launches=1)


def bwd_kernel_info(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> dict[str, int]:
    """What ``rms_norm_bwd`` launches for these CUDA tensors: registers and
    local (spill) bytes a thread, dynamic shared memory and threads a block,
    blocks of the row kernel, and launches (1, or 2 with the column sum of
    the dw partials); builds the kernels on first use."""
    _check_rows(x, w, dy)
    fn = build.library("rmsnorm_bwd").rmsnorm_bwd_info
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i, ctypes.c_longlong, i, i, p]
    fn.restype = i
    out = (ctypes.c_int * 6)()
    n, d = x.shape
    # dx is allocated like x, so its alignment is x's
    build.check(fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), x.data_ptr(), _DTYPES[x.dtype],
                   n, d, _bwd_max_blocks(x), ctypes.addressof(out)), "rmsnorm_bwd_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "blocks", "launches"),
                    out))


class RMSNormFused(torch.autograd.Function):
    """Differentiable fused RMSNorm over the last axis (any leading shape):
    ``rms_norm_fwd`` forward, ``rms_norm_bwd`` backward on the rows reshaped
    to (N, D); dw comes back in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        y = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        d = x.shape[-1]
        dx, dw = rms_norm_bwd(
            x.reshape(-1, d), w, dy.reshape(-1, d).contiguous(), ctx.eps
        )
        return dx.reshape(x.shape), dw.to(w.dtype), None


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last axis; any leading shape."""
    return RMSNormFused.apply(x, w, eps)
