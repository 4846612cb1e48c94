"""RG-LRU linear recurrence ops: the sequential oracle, a parallel (doubling)
scan, and the hand-written CUDA kernel.

The recurrence ``h_t = a_t h_{t-1} + b_t`` is the composition of affine
maps.  The reference evaluates all prefixes with ``jax.lax.associative_scan``
(the TPU's realisation); PyTorch has no public associative scan, so
``linear_recurrence_assoc`` is a log-depth doubling scan over the time axis
with the same combine and the initial state folded into the first element.
On the card the recurrence is the CUDA kernel ``rglru_fwd``
(``csrc/rglru.cu``), which replaces the Pallas TPU kernel ``rglru_pallas``
of ``src/repro/kernels/rglru/kernel.py``: one pass over (128-step chunk,
32-channel slab) blocks, each folding its chunk into one affine map and
taking the state entering it from the chunks before by a decoupled
look-back.

``rglru_fwd`` launches the kernel on CUDA tensors (inside an
``autograd.Function`` whose backward raises: there is no backward kernel
yet) and returns its plain version on CPU tensors, where autograd sees plain
torch ops.  ``launches`` counts kernel launches only (one per call; the
call also clears the look-back's words with one memset).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import linear_recurrence_ref

__all__ = [
    "kernel_plan",
    "linear_recurrence",
    "linear_recurrence_assoc",
    "linear_recurrence_ref",
    "rglru_fwd",
    "rglru_fwd_plain",
]

#: rglru_fwd kernel launches since the counter was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NO_BACKWARD = ("rglru_fwd has no backward kernel (ROADMAP Queue 2 item 5: the reverse-scan "
                "kernels, which the reference lacks too); train through seq_impl='parallel', "
                "as the reference's blocks do")


def linear_recurrence_assoc(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """All prefixes of the affine maps ``(a_t, b_t)`` in ceil(log2 S) doubling
    steps (Hillis-Steele), f32 inside; ``h0`` folded into ``b_0``.  a (B, S,
    ...) may broadcast against b (B, S, ...) along the trailing dimensions."""
    af, bf = a.float(), b.float()
    if h0 is not None:
        bf = torch.cat([bf[:, :1] + af[:, :1] * h0.float()[:, None], bf[:, 1:]], dim=1)
    off = 1
    while off < af.shape[1]:
        # combine(left = prefix ending at t - off, right = prefix ending at t)
        bf = torch.cat([bf[:, :off], bf[:, :-off] * af[:, off:] + bf[:, off:]], dim=1)
        af = torch.cat([af[:, :off], af[:, :-off] * af[:, off:]], dim=1)
        off *= 2
    return bf.to(a.dtype), bf[:, -1]


def rglru_fwd_plain(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the sequential f32 recurrence, step by
    step.  The kernel composes chunks of steps in another order, so the two
    agree within the f32 tolerance and not bit for bit."""
    return linear_recurrence_ref(a, b, h0)


def _lib():
    lib = build.library("rglru")
    if lib.rglru_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rglru_fwd.argtypes = [p] * 6 + [i] * 4 + [ll] * 4 + [p]
        lib.rglru_fwd.restype = i
        lib.rglru_fwd_scratch.argtypes = [i] * 3
        lib.rglru_fwd_scratch.restype = ll
        lib.rglru_fwd_grid.argtypes = [i] * 3 + [p]
        lib.rglru_fwd_grid.restype = i
    return lib


def kernel_plan(b: int, s: int, d: int) -> tuple[int, int]:
    """(blocks, threads a block) of the launch at (B, S, D) (loads the
    kernels; needs the card)."""
    out = (ctypes.c_int * 2)()
    build.check(_lib().rglru_fwd_grid(b, s, d, ctypes.addressof(out)), "rglru_fwd_grid")
    return out[0], out[1]


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru kernel takes f32/bf16 a and b of one dtype, got {a.dtype}/{b.dtype}")
    if a.dim() != 3 or b.shape != a.shape or a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError(f"rglru kernel needs a, b (B, S, D) with a contiguous channel axis, "
                         f"got {tuple(a.shape)} {a.stride()} / {tuple(b.shape)} {b.stride()}")
    bsz, _, d = a.shape
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (bsz, d)
                           or not h0.is_contiguous()):
        raise ValueError(f"rglru kernel needs a contiguous f32 h0 ({bsz}, {d}), got "
                         f"{h0.dtype} {tuple(h0.shape)}")


def _launch(a, b, h0):
    _check(a, b, h0)
    bsz, s, d = a.shape
    y = torch.empty((bsz, s, d), dtype=a.dtype, device=a.device)
    h_out = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
    if s == 0 or bsz == 0 or d == 0:
        return y, (h_out.zero_() if h0 is None else h_out.copy_(h0))
    lib = _lib()
    scratch = torch.empty(lib.rglru_fwd_scratch(bsz, s, d), dtype=torch.int64,
                          device=a.device)
    err = lib.rglru_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), scratch.data_ptr(), _DTYPES[a.dtype], bsz, s, d,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "rglru_fwd")
    global launches
    launches += 1
    return y, h_out


class _RGLRUKernel(torch.autograd.Function):
    """The kernel as an autograd node: forward only, backward refuses."""

    @staticmethod
    def forward(ctx, a, b, h0):
        return _launch(a, b, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        raise NotImplementedError(_NO_BACKWARD)


def rglru_fwd(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (B, S, D); h0 (B, D) f32 or None -> (y (B, S, D) in a's dtype,
    final state (B, D) f32): the kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if not build.on_cuda(a, b, *(() if h0 is None else (h0,)), kernel="rglru_fwd"):
        return rglru_fwd_plain(a, b, h0)
    return _RGLRUKernel.apply(a, b, h0)


def linear_recurrence(
    a: torch.Tensor,
    b: torch.Tensor,
    h0: torch.Tensor | None = None,
    impl: str = "assoc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``impl``: "ref" (sequential), "assoc" (doubling scan) or "pallas" (the
    reference's name for its kernel: here ``rglru_fwd``)."""
    if impl == "ref":
        return linear_recurrence_ref(a, b, h0)
    if impl == "assoc":
        return linear_recurrence_assoc(a, b, h0)
    if impl == "pallas":
        return rglru_fwd(a, b, h0)
    raise ValueError(f"unknown rglru impl {impl!r}")
