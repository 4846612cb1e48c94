"""Flash attention, forward and backward: the CUDA kernels on the card, their
plain PyTorch versions on the CPU, and the ``autograd.Function`` that joins
them.

The kernels replace the Pallas TPU kernels of
``src/repro/kernels/flash_attention/kernel.py``: ``flash_fwd``
(``csrc/flash_attention.cu``), ``flash_bwd_dq`` and ``flash_bwd_dkv``
(``csrc/flash_attention_bwd.cu``).  They read q/k/v in the model layout
(B, S, H, hd) / (B, T, KV, hd) through their strides — no transposes, unlike
the reference wrapper — and mask ragged S and T themselves, so every sequence
length on the card goes through them; the reference's untiled fallback to
``chunked_attention`` is deliberately absent.  The dkv kernel sums over the
GQA group inside each block and returns dk/dv already reduced to the KV
heads.  In bf16 all three kernels run on the tensor cores (``wgmma`` fed
by TMA, sm_90a) at head_dim 32 to 256 (the dkv kernel with dv and dk on
the two warpgroups of a 64-key block and, where that grid is under one
wave of SMs, the GQA group's query heads split across blocks:
:func:`dkv_split`); every f32 instance, and the bf16 one at head_dim 16
(the smoke configs'), uses f32 FMAs from shared memory.
PERF.md has their times against their bounds.

TMA reads a bf16 tensor only from a 16-byte-aligned address with byte
strides that are multiples of 16 (:func:`tma_strides`); the wrappers raise
``ValueError`` on a CUDA tensor that the tensor-core kernels get and that
breaks this, with no copy and no fallback.

``flash_attention`` goes through :class:`FlashAttention` on both devices, so
a loss on the card differentiates through the kernels: forward saves q, k, v,
out and lse; backward forms ``delta = rowsum(do · out)`` in f32 (one torch
expression, as the reference's ``ops.py`` does outside its kernels) and runs
dq and dkv.  Gradients come back in the inputs' dtypes.

``launches``, ``dq_launches`` and ``dkv_launches`` count kernel calls only
(never the plain versions' calls); one counted dkv call is one launch, or
two where the group is split (the split kernel, then the fixed-order sum of
its partials: :func:`dkv_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = [
    "FlashAttention",
    "dkv_plan",
    "dkv_split",
    "flash_attention",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_bwd_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "kernel_info",
    "tma_strides",
]

#: flash_fwd kernel launches since the counter was last set to 0
launches = 0
#: flash_bwd_dq kernel launches since the counter was last set to 0
dq_launches = 0
#: flash_bwd_dkv kernel launches since the counter was last set to 0
dkv_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the forward and backward kernels (256: recurrentgemma-9b's
#: MQA heads, which train through all three)
_HEAD_DIMS = (16, 32, 64, 128, 256)
#: keys of a tensor-core dkv block (``tc::DkvTiles::BK`` of
#: csrc/flash_attention_bwd.cu, at every head_dim from 32 to 256) and of an
#: f32-FMA one (``KV_BK``)
_DKV_TC_KEYS, _DKV_FMA_KEYS = 64, 32
#: lse or delta values a tensor-core dkv tile loads by TMA in one box of a
#: 1-d map (``tc::DkvTiles::ROW_BOX``): its 64 query rows, from the 16-byte
#: boundary at or below the first
_DKV_ROW_BOX = 68


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _allowed(s: int, t: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, T) bool mask of admissible (query, key) pairs."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def _grouped(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> f32 (B, S, KV, G, hd)."""
    b, s, h, hd = x.shape
    return x.float().reshape(b, s, n_kv, h // n_kv, hd)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, all in f32: masked scores
    ``q·kᵀ · hd**-0.5``, exact softmax, ``p·v``.  Returns (out in q's dtype,
    lse (B, H, S) f32).  Every query row must admit at least one key."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    scores = torch.einsum("bskgd,btkd->bkgst", _grouped(q, n_kv), k.float()) * hd ** -0.5
    scores = scores.masked_fill(~_allowed(s, t, causal, window, q.device), float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float()).reshape(b, s, h, hd)
    return out.to(q.dtype), lse.reshape(b, h, s)


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    """f32 p = exp(s·scale − lse) and ds = p·(do·vᵀ − delta), (B, KV, G, S, T)."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scores = torch.einsum("bskgd,btkd->bkgst", _grouped(q, n_kv), k.float()) * hd ** -0.5
    scores = scores.masked_fill(~_allowed(s, t, causal, window, q.device), float("-inf"))
    probs = torch.exp(scores - lse.float().reshape(b, n_kv, g, s, 1))
    dp = torch.einsum("bskgd,btkd->bkgst", _grouped(do, n_kv), v.float())
    ds = probs * (dp - delta.float().reshape(b, n_kv, g, s, 1))
    return probs, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool, window: int | None):
    """dq of the dq kernel in plain PyTorch (f32 inside, q's dtype out)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    b, s, h, hd = q.shape
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * hd ** -0.5
    return dq.reshape(b, s, h, hd).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool, window: int | None):
    """(dk, dv) of the dkv kernel in plain PyTorch, summed over the GQA group
    in f32 and returned in k's and v's dtypes."""
    probs, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    n_kv, hd = k.shape[2], q.shape[3]
    dk = torch.einsum("bkgst,bskgd->btkd", ds, _grouped(q, n_kv)) * hd ** -0.5
    dv = torch.einsum("bkgst,bskgd->btkd", probs, _grouped(do, n_kv))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do · out) in f32, (B, H, S) contiguous."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do, *, causal: bool, window: int | None):
    """The backward in plain PyTorch, f32 inside: ``delta = rowsum(do·out)``,
    then (dq, dk, dv) in q's, k's and v's dtypes, dk/dv summed over the GQA
    group."""
    delta = _delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, window, *more, head_dims=_HEAD_DIMS) -> None:
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    tensors = (q, k, v, *more)
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in tensors):
        raise TypeError("flash kernels take f32/bf16 tensors of one dtype, got "
                        + "/".join(str(x.dtype) for x in tensors))
    if hd not in head_dims or k.shape != (b, t, n_kv, hd) or v.shape != k.shape:
        raise ValueError(f"flash kernel shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head_dim must be one of {head_dims}")
    if any(x.shape != q.shape for x in more):
        raise ValueError(f"flash kernel: do must match q {tuple(q.shape)}")
    if h % n_kv or min(x.stride(-1) for x in tensors) != 1:
        raise ValueError("flash kernel needs H % KV == 0 and a contiguous head_dim axis")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def tma_strides(shape, strides, dtype: torch.dtype, address: int) -> tuple[int, ...]:
    """The (batch, sequence, head) element strides that a tensor map of the
    tensor-core kernels is given for a (B, L, heads, hd) tensor, or
    ``ValueError`` when TMA cannot read it: the base address must be 16-byte
    aligned, the head_dim axis contiguous and every other stride a multiple
    of 16 bytes.  The stride of an axis of extent 1 is never used to address
    memory, so it is replaced by the tensor's whole span, 16-byte aligned."""
    if address % 16:
        raise ValueError(f"TMA needs a 16-byte-aligned base address, got {address:#x}")
    if strides[3] != 1:
        raise ValueError(f"TMA needs a contiguous head_dim axis, got strides {tuple(strides)}")
    out = list(strides[:3])
    for i in range(3):
        if shape[i] == 1:
            out[i] = -(-max(n * st for n, st in zip(shape, strides)) // 16) * 16
        elif out[i] * dtype.itemsize % 16:
            raise ValueError(f"TMA needs byte strides that are multiples of 16, got element "
                             f"strides {tuple(strides)} for shape {tuple(shape)} ({dtype})")
    return tuple(out)


def _strides(x: torch.Tensor, tensor_cores: bool) -> tuple[int, ...]:
    """(batch, sequence, head) strides of a kernel input: checked for TMA
    for a tensor-core kernel, as they are for the CUDA-core ones."""
    if not tensor_cores:
        return x.stride()[:3]
    return tma_strides(x.shape, x.stride(), x.dtype, x.data_ptr())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_kernel():
    fn = build.library("flash_attention").flash_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [i] * 7 + [ll] * 12 + [i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _bwd_kernel(name: str):
    fn = getattr(build.library("flash_attention_bwd"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "flash_bwd_dq":
            fn.argtypes = [p] * 7 + [i] * 7 + [p, i, i, ctypes.c_float, p]
        else:  # two outputs, then the split and its workspace
            fn.argtypes = [p] * 8 + [i] * 7 + [p, i, i, ctypes.c_float, i, p, p]
        fn.restype = i
    return fn


def _dkv_tc_blocks(b: int, t: int, n_kv: int) -> int:
    """Blocks of the unsplit tensor-core dkv kernel: one a key tile of 64
    keys, KV head and batch row."""
    return -(-t // _DKV_TC_KEYS) * n_kv * b


def dkv_split(b: int, t: int, n_kv: int, group: int, head_dim: int, sms: int) -> int:
    """Blocks that each key tile of the bf16 tensor-core dkv kernel (head_dim
    32 to 256) is split into over the GQA group's ``group`` query heads.  1
    wherever the grid of one block a key tile of 64 — ceil(T / 64) x KV x B
    — already fills ``sms`` SMs (training at batch 4); otherwise (a batch
    row or two: the pipeline's microbatch, a rank's shard, MQA at hd 256)
    the least divisor of the group that makes the grid two waves, or the
    whole group where none does (each split then holds one head).  Two
    waves, not one: a causal or windowed mask gives key tiles unequal work,
    and blocks of half a wave's length let the SMs that finish early take
    the rest (``tools/time_flash.py --dkv-splits`` times every split on the
    card; PERF.md has the times)."""
    if head_dim < 32:  # hopper::tensor_core_hd: the f32-FMA instance
        return 1
    blocks = _dkv_tc_blocks(b, t, n_kv)
    if blocks >= sms:
        return 1
    return next((d for d in range(2, group + 1) if group % d == 0 and blocks * d >= 2 * sms),
                group)


def dkv_plan(b: int, t: int, n_kv: int, group: int, head_dim: int, dtype: torch.dtype,
             sms: int) -> dict[str, int]:
    """What a ``flash_bwd_dkv`` call launches for these shapes on a card of
    ``sms`` SMs: ``split`` (:func:`dkv_split` for the tensor-core
    instances, 1 for the f32-FMA ones), ``blocks`` of the dkv kernel,
    ``launches`` (2 with a split: the fixed-order sum follows) and the f32
    ``workspace_bytes`` of the split's partial dk and dv, 2 x split x B x T
    x KV x head_dim x 4 (0 without one)."""
    if dtype != torch.bfloat16 or head_dim < 32:  # hopper::tensor_core_hd
        return dict(split=1, blocks=-(-t // _DKV_FMA_KEYS) * n_kv * b, launches=1,
                    workspace_bytes=0)
    split = dkv_split(b, t, n_kv, group, head_dim, sms)
    return dict(split=split, blocks=_dkv_tc_blocks(b, t, n_kv) * split,
                launches=1 + (split > 1),
                workspace_bytes=0 if split == 1 else 2 * split * b * t * n_kv * head_dim * 4)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def kernel_info(name: str, dtype: torch.dtype, head_dim: int, split: int = 1) -> dict[str, int]:
    """Registers and local (spill) bytes a thread, dynamic shared memory and
    threads a block of the kernel instance that ``flash_fwd``,
    ``flash_bwd_dq`` or ``flash_bwd_dkv`` (with ``split``, see
    :func:`dkv_plan`) launches for ``dtype`` and ``head_dim``, and
    ``tensor_cores``: 1 for a tensor-core kernel, whose inputs the wrapper
    checks for TMA (builds the kernels on first use; needs the card)."""
    lib = build.library({"flash_fwd": "flash_attention", "flash_bwd_dq": "flash_attention_bwd",
                         "flash_bwd_dkv": "flash_attention_bwd"}[name])
    fn = getattr(lib, f"{name}_info")
    dkv = name == "flash_bwd_dkv"
    fn.argtypes = [ctypes.c_int] * (3 if dkv else 2) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    args = (_DTYPES[dtype], head_dim) + ((split,) if dkv else ())
    build.check(fn(*args, ctypes.addressof(out)), f"{name}_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "tensor_cores"), out))


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (out (B,S,H,hd), lse (B,H,S) f32)."""
    if not build.on_cuda(q, k, v, kernel="flash_fwd"):
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    tc = kernel_info("flash_fwd", q.dtype, hd)["tensor_cores"]
    err = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPES[q.dtype], b, s, t, h, n_kv, hd,
        *(n for x in (q, k, v) for n in _strides(x, tc)), *out.stride()[:3],
        int(causal), window or 0, hd ** -0.5, _stream(q),
    )
    build.check(err, "flash_fwd")
    global launches
    launches += 1
    return out, lse


def _tma_vector(x: torch.Tensor) -> torch.Tensor:
    """lse or delta as the backward kernels read them: contiguous f32 and,
    for the dkv kernel's TMA, from a 16-byte-aligned base and at least one
    box (``_DKV_ROW_BOX`` elements) long: a zero-padded copy where it is not."""
    x = x.float().contiguous()
    if x.data_ptr() % 16 == 0 and x.numel() >= _DKV_ROW_BOX:
        return x
    out = torch.zeros(max(x.numel(), _DKV_ROW_BOX), dtype=torch.float32, device=x.device)
    out[:x.numel()] = x.reshape(-1)
    return out


def _launch_bwd(name, q, k, v, do, lse, delta, outs, causal, window) -> None:
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if lse.shape != (b, h, s) or delta.shape != (b, h, s):
        raise ValueError(f"lse/delta must be (B, H, S) = {(b, h, s)}")
    lse, delta = _tma_vector(lse), _tma_vector(delta)
    dq = outs[0] if name == "flash_bwd_dq" else q
    dk, dv = (outs if name == "flash_bwd_dkv" else (k, v))
    tc = kernel_info(name, q.dtype, hd)["tensor_cores"]
    ins = [_strides(x, tc) for x in (q, k, v, do)]
    strides = [n for st in ins + [x.stride()[:3] for x in (dq, dk, dv)] for n in st]
    st = (ctypes.c_longlong * len(strides))(*strides)
    split = ()
    if name == "flash_bwd_dkv":
        plan = dkv_plan(b, t, n_kv, h // n_kv, hd, q.dtype, _sm_count(q.device))
        ws = None
        if plan["split"] > 1:  # freed on return: later work on this stream runs after the sum
            ws = torch.empty((plan["workspace_bytes"] // 4,), dtype=torch.float32,
                             device=q.device)
        split = (plan["split"], None if ws is None else ws.data_ptr())
    err = _bwd_kernel(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(o.data_ptr() for o in outs),
        _DTYPES[q.dtype], b, s, t, h, n_kv, hd, ctypes.addressof(st),
        int(causal), window or 0, hd ** -0.5, *split, _stream(q),
    )
    build.check(err, name)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True, window: int | None = None):
    """dq (B,S,H,hd) from q, do (B,S,H,hd), k/v (B,T,KV,hd) and f32 lse and
    delta (B,H,S): the dq kernel on CUDA tensors, its plain version on CPU."""
    if not build.on_cuda(q, k, v, do, lse, delta, kernel="flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    _check(q, k, v, window, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.shape[1] == 0 or k.shape[1] == 0:
        return dq.zero_()
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal, window)
    global dq_launches
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True, window: int | None = None):
    """(dk, dv) (B,T,KV,hd), summed over the GQA group: the dkv kernel on CUDA
    tensors, its plain version on CPU.  One counted call is one launch, or
    two where :func:`dkv_plan` splits the group (the split kernel into an f32
    workspace, then its sum in split order: the same bits on every run)."""
    if not build.on_cuda(q, k, v, do, lse, delta, kernel="flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    _check(q, k, v, window, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.shape[1] == 0 or k.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal, window)
    global dkv_launches
    dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, out, lse, do, *, causal: bool = True, window: int | None = None):
    """(dq, dk, dv) from the forward's q, k, v, out, lse and the output
    gradient ``do``: delta in f32, then the dq and dkv kernels (their plain
    versions on CPU tensors)."""
    if not build.on_cuda(q, k, v, out, lse, do, kernel="flash_bwd"):
        return flash_bwd_plain(q, k, v, out, lse, do, causal=causal, window=window)
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = _delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``flash_fwd`` forward, ``flash_bwd``
    backward (kernels on CUDA tensors, plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Model layout in/out: q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)."""
    return FlashAttention.apply(q, k, v, causal, window)
