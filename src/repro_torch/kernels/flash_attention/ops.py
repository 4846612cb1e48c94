"""Flash-attention forward: the CUDA kernel on the card, its plain PyTorch
version on the CPU.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``flash_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``.  It reads
q/k/v in the model layout (B, S, H, hd) / (B, T, KV, hd) through their
strides — no transposes, unlike the reference wrapper — and masks ragged S
and T itself, so every prefill on the card goes through it; the reference's
untiled fallback to ``chunked_attention`` is deliberately absent.  On the
H100 a tensor-core version of this work would be memory bound (~1.6 us at
S = T = 512, 32 heads); this first version uses f32 FMAs from shared memory
and is bound by those instead (PERF.md has its time).  ``launches`` counts
kernel launches only.  Forward only: the backward kernels come with the
training path.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain"]

#: kernel launches since the counter was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, all in f32: masked scores
    ``q·kᵀ · hd**-0.5``, exact softmax, ``p·v``.  Returns (out in q's dtype,
    lse (B, H, S) f32).  Every query row must admit at least one key."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, n_kv, h // n_kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    scores = scores.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float()).reshape(b, s, h, hd)
    return out.to(q.dtype), lse.reshape(b, h, s)


def _kernel():
    fn = build.library("flash_attention").flash_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [i] * 7 + [ll] * 12 + [i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (out (B,S,H,hd), lse (B,H,S) f32)."""
    if not build.on_cuda(q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32/bf16 q, k, v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS or k.shape != (b, t, n_kv, hd) or v.shape != k.shape:
        raise ValueError(f"flash kernel shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head_dim must be one of {_HEAD_DIMS}")
    if h % n_kv or min(q.stride(-1), k.stride(-1), v.stride(-1)) != 1:
        raise ValueError("flash kernel needs H % KV == 0 and a contiguous head_dim axis")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPES[q.dtype], b, s, t, h, n_kv, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), window or 0, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_fwd")
    global launches
    launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Model layout in/out: q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)."""
    return flash_fwd(q, k, v, causal=causal, window=window)[0]
