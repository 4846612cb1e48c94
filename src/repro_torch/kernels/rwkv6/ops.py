"""WKV-6 ops: the sequential oracle, the chunked-parallel form, and the
hand-written CUDA kernel.

Chunked derivation (stable: every exponent is ≤ 0 inside a chunk):
with in-chunk inclusive log-decay ``L_t = Σ_{j≤t} log w_j`` and
``L⁻_t = L_t − log w_t`` (exclusive),

    y_t  = (r_t ⊙ e^{L⁻_t}) · S_in                     (inter-chunk)
         + Σ_{m<t} [Σ_i r_{t,i} k_{m,i} e^{L⁻_{t,i} − L_{m,i}}] v_m
         + (r_t ⊙ u) · k_t  v_t                        (diagonal bonus)
    S_out = diag(e^{L_{C−1}}) S_in + Σ_m (e^{L_{C−1} − L_m} ⊙ k_m) v_mᵀ

All pairwise exponents have m ≤ t so they are sums of negative log-decays —
no overflow; underflow saturates to 0 which is exact in the limit.

On the card the recurrence is the CUDA kernel ``wkv6_fwd``
(``csrc/rwkv6.cu``), which replaces the Pallas TPU kernel ``wkv6_pallas``
of ``src/repro/kernels/rwkv6/kernel.py``: this chunked form in three
launches over (time chunk, batch row x head) grids -- each chunk's decay and
state contribution, the carry of the state across chunks, then each chunk's
outputs -- reading the inputs in the model's (B, S, H, K) layout through
their strides.  ``wkv6_fwd`` launches it on CUDA tensors (inside an
``autograd.Function`` whose backward raises: there is no backward kernel
yet) and returns its plain version on CPU tensors.  ``launches`` counts
calls that launched the kernel (one per call, for its three launches), never
the plain version's.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import wkv6_ref

__all__ = ["kernel_plan", "wkv6", "wkv6_chunked", "wkv6_fwd", "wkv6_fwd_plain", "wkv6_ref"]

#: wkv6_fwd kernel calls (three launches each) since the counter was last set to 0
launches = 0

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_SIZES = (16, 32, 64)
#: the kernels' grids put batch row x head on the y axis, which CUDA caps
_MAX_BATCH_HEADS = 65535
_NO_BACKWARD = ("wkv6_fwd has no backward kernel (ROADMAP Queue 2 item 5: the reverse-scan "
                "kernels, which the reference lacks too); train through seq_impl='parallel', "
                "as the reference's blocks do")


def _chunk_body(u, S, rf, kf, vf, logw):
    """One chunk: rf/kf/logw (B,C,H,K), vf (B,C,H,V), S (B,H,K,V) f32."""
    l_incl = torch.cumsum(logw, dim=1)
    l_excl = l_incl - logw
    y_inter = torch.einsum("bchk,bhkv->bchv", rf * torch.exp(l_excl), S)
    expo = l_excl[:, :, None] - l_incl[:, None, :]  # (B, C_t, C_m, H, K)
    c = rf.shape[1]
    pos = torch.arange(c, device=rf.device)
    mask = (pos[:, None] > pos[None, :])[None, :, :, None, None]
    expo = expo.clamp_max(0.0).masked_fill(~mask, _NEG)
    scores = torch.einsum("bthk,bmhk,btmhk->btmh", rf, kf, torch.exp(expo))
    diag = torch.einsum("bthk,hk,bthk->bth", rf, u, kf)
    y_intra = torch.einsum("btmh,bmhv->bthv", scores, vf) + diag[..., None] * vf
    l_last = l_incl[:, -1]  # (B,H,K)
    k_dec = kf * torch.exp(l_last[:, None] - l_incl)
    S_new = torch.exp(l_last)[..., None] * S + torch.einsum("bmhk,bmhv->bhkv", k_dec, vf)
    return S_new, y_inter + y_intra


def wkv6_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked-parallel form; sequences that are not a multiple of
    ``chunk`` long, or no longer than one chunk, take the oracle."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s % chunk != 0 or s <= chunk:
        return wkv6_ref(r, k, v, w, u, state)
    n = s // chunk
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    rf = r.float().reshape(b, n, chunk, h, dk)
    kf = k.float().reshape(b, n, chunk, h, dk)
    vf = v.float().reshape(b, n, chunk, h, dv)
    logw = torch.log(w.float().clamp_min(1e-38)).reshape(b, n, chunk, h, dk)
    uf = u.float()
    S = state.float()
    ys = []
    for i in range(n):
        S, y = _chunk_body(uf, S, rf[:, i], kf[:, i], vf[:, i], logw[:, i])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, h, dv).to(r.dtype), S


def wkv6_fwd_plain(r, k, v, w, u, state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the sequential f32 recurrence, step by
    step.  The kernel sums in chunks, in another order, so the two agree
    within the f32 tolerance and not bit for bit."""
    return wkv6_ref(r, k, v, w, u, state)


def _lib():
    lib = build.library("rwkv6")
    if lib.wkv6_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_fwd.argtypes = [p] * 9 + [i] * 6 + [p, p]
        lib.wkv6_fwd.restype = i
        lib.wkv6_fwd_scratch.argtypes = [i] * 4
        lib.wkv6_fwd_scratch.restype = ctypes.c_longlong
        lib.wkv6_fwd_grid.argtypes = [i] * 4 + [p]
        lib.wkv6_fwd_grid.restype = i
    return lib


def kernel_plan(b: int, s: int, h: int, k: int) -> list[tuple[str, int, int, int]]:
    """(name, blocks, threads a block, dynamic shared memory bytes a block) of
    the three launches of one call at (B, S, H, K) (loads the kernels; needs
    the card)."""
    out = (ctypes.c_int * 9)()
    build.check(_lib().wkv6_fwd_grid(b, s, h, k, ctypes.addressof(out)), "wkv6_fwd_grid")
    names = ("chunk states", "carry", "chunk outputs")
    return [(name, *out[3 * n: 3 * n + 3]) for n, name in enumerate(names)]


def _check(r, k, v, w, u, state) -> None:
    b, s, h, dk = r.shape
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype or w.dtype not in _DTYPES:
        raise TypeError(f"wkv6 kernel takes f32/bf16 r, k, v of one dtype and f32/bf16 w, got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}")
    if dk not in _HEAD_SIZES or v.shape != r.shape or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"wkv6 kernel shapes: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}; K = V in {_HEAD_SIZES}")
    if min(x.stride(-1) for x in (r, k, v, w)) != 1:
        raise ValueError("wkv6 kernel needs a contiguous channel axis in r, k, v, w")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"wkv6 kernel takes at most {_MAX_BATCH_HEADS} batch rows x heads "
                         f"(its grid's second axis), got {b} x {h}")
    if u.dtype != torch.float32 or u.shape != (h, dk) or not u.is_contiguous():
        raise ValueError(f"wkv6 kernel needs a contiguous f32 u ({h}, {dk}), got "
                         f"{u.dtype} {tuple(u.shape)}")
    if state is not None and (state.dtype != torch.float32 or state.shape != (b, h, dk, dk)
                              or not state.is_contiguous()):
        raise ValueError(f"wkv6 kernel needs a contiguous f32 state {(b, h, dk, dk)}, got "
                         f"{state.dtype} {tuple(state.shape)}")


def _launch(r, k, v, w, u, state):
    _check(r, k, v, w, u, state)
    b, s, h, dk = r.shape
    y = torch.empty((b, s, h, dk), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, dk, dk), dtype=torch.float32, device=r.device)
    if b == 0 or s == 0 or h == 0:
        return y, (s_out.zero_() if state is None else s_out.copy_(state))
    strides = [n for x in (r, k, v, w) for n in (x.stride(0), x.stride(1), x.stride(2))]
    st = (ctypes.c_longlong * len(strides))(*strides)
    lib = _lib()
    scratch = torch.empty(lib.wkv6_fwd_scratch(b, s, h, dk), dtype=torch.float32,
                          device=r.device)
    err = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        scratch.data_ptr(), _DTYPES[r.dtype], _DTYPES[w.dtype], b, s, h, dk,
        ctypes.addressof(st),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    build.check(err, "wkv6_fwd")
    global launches
    launches += 1
    return y, s_out


class _WKV6Kernel(torch.autograd.Function):
    """The kernel as an autograd node: forward only, backward refuses."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        return _launch(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, ds):
        raise NotImplementedError(_NO_BACKWARD)


def wkv6_fwd(r, k, v, w, u, state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w (B,S,H,K), v (B,S,H,V), u (H,K) f32, state (B,H,K,V) f32 or
    None -> (y (B,S,H,V) in r's dtype, final state f32): the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if not build.on_cuda(r, k, v, w, u, *(() if state is None else (state,)),
                         kernel="wkv6_fwd"):
        return wkv6_fwd_plain(r, k, v, w, u, state)
    return _WKV6Kernel.apply(r, k, v, w, u, state)


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    impl: str = "chunked",
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 with implementation dispatch: "ref", "chunked" or "pallas" (the
    reference's name for its kernel: here ``wkv6_fwd``)."""
    if impl == "ref":
        return wkv6_ref(r, k, v, w, u, state)
    if impl == "chunked":
        return wkv6_chunked(r, k, v, w, u, state, chunk=chunk)
    if impl == "pallas":
        return wkv6_fwd(r, k, v, w, u, state)
    raise ValueError(f"unknown wkv6 impl {impl!r}")
