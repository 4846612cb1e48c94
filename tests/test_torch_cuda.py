"""PyTorch port on the card: each CUDA kernel against its plain version, and
the launch counters.  Marked ``cuda``; every test skips where there is no
CUDA device (decided inside the fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,kv,hd,causal,window", [
    (512, 512, 32, 8, 64, True, None),
    (300, 300, 32, 8, 64, True, None),
    (256, 256, 4, 4, 32, True, 128),
    (128, 256, 2, 1, 64, False, None),
    (100, 100, 4, 2, 128, True, None),
    (512, 512, 16, 1, 256, True, 2048),      # recurrentgemma-9b: MQA, hd 256
    (300, 300, 16, 1, 256, True, 128),       # hd 256, ragged, the window bites
    (128, 128, 4, 2, 16, True, None),        # the smoke configs' hd 16
    (128, 128, 4, 1, 16, True, 16),          # recurrentgemma-9b smoke: MQA, window 16
    (37, 37, 4, 2, 16, True, None),          # hd 16, ragged S
    (512, 512, 16, 16, 64, False, None),     # seamless-m4t-large-v2: MHA, not causal
    (300, 300, 16, 16, 64, False, None),     # its encoder, ragged
    (300, 512, 16, 16, 64, False, None),     # its cross-attention, S != T
    (512, 300, 16, 16, 64, False, None),
])
def test_flash_kernel_matches_plain(gen, dtype, s, t, h, kv, hd, causal, window):
    q = torch.randn((2, s, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, t, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, t, kv, hd), generator=gen, device="cuda").to(dtype)
    before = fa_ops.launches
    out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(512, 2048), (4, 2048), (16384, 64), (7, 100),
                                 (512, 1024), (300, 1024), (4, 1024), (4096, 1024)])
def test_rmsnorm_kernel_matches_plain(gen, dtype, n, d):
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((d,), generator=gen, device="cuda").to(dtype)
    before = rn_ops.launches
    y = rn_ops.rms_norm_fused(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn_ops.launches == before + 1
    ref = rn_ops.rms_norm_plain(x, w, 1e-5)
    torch.testing.assert_close(y.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 5e-4}  # tests/test_kernels_flash.py:62


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (2, 512, 512, 32, 8, 64, True, None),    # the training heads, GQA group 4
    (1, 300, 300, 8, 2, 64, True, None),     # ragged S = T
    (2, 256, 256, 4, 4, 32, True, 128),      # sliding window
    (1, 128, 256, 2, 1, 64, False, None),    # cross-shape, MQA
    (1, 100, 100, 4, 2, 128, True, None),    # ragged, wide head
    (1, 200, 200, 4, 2, 64, False, 48),      # window without causality
    (2, 128, 128, 4, 2, 16, True, None),     # the smoke configs' hd 16
    (1, 128, 128, 4, 1, 16, True, 16),       # hd 16, MQA, window 16
    (1, 37, 37, 4, 2, 16, True, None),       # hd 16, ragged S
    (1, 512, 512, 16, 1, 256, True, 2048),   # recurrentgemma-9b: MQA, hd 256
    (1, 300, 300, 16, 1, 256, True, 128),    # hd 256, ragged, the window bites
    (1, 256, 256, 4, 2, 256, False, None),   # hd 256, no mask, GQA group 2
    (2, 512, 512, 16, 16, 64, False, None),  # seamless-m4t-large-v2: MHA, not causal
    (1, 300, 300, 16, 16, 64, False, None),  # its encoder, ragged
    (1, 300, 512, 16, 16, 64, False, None),  # its cross-attention, S != T
    (1, 512, 300, 16, 16, 64, False, None),
])
def test_flash_bwd_kernels_match_plain(gen, dtype, b, s, t, h, kv, hd, causal, window):
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    out, lse = fa_ops.flash_fwd_plain(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = (fa_ops.dq_launches, fa_ops.dkv_launches)
    dq = fa_ops.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = fa_ops.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fa_ops.dq_launches, fa_ops.dkv_launches) == (before[0] + 1, before[1] + 1)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert dk.shape == dv.shape == (b, t, kv, hd)
    ref_dq = fa_ops.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                                window=window)
    tol = BWD_TOL[dtype]
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _flash_case(gen, b, s, t, h, kv, hd, causal, window, q=None, k=None, v=None):
    """The bf16 tensor-core forward, dq and dkv kernels against their plain
    versions on one case, with the launch counters checked."""
    dtype = torch.bfloat16
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype) if q is None else q
    k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype) if k is None else k
    v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype) if v is None else v
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    mask = dict(causal=causal, window=window)
    with_bwd = hd in fa_ops._HEAD_DIMS  # every head dim of the forward, 256 included
    before = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches)
    out, lse = fa_ops.flash_fwd(q, k, v, **mask)
    ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
    if with_bwd:
        dq = fa_ops.flash_bwd_dq(q, k, v, do, ref_lse, delta, **mask)
        dk, dv = fa_ops.flash_bwd_dkv(q, k, v, do, ref_lse, delta, **mask)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches) == (
        before[0] + 1, before[1] + int(with_bwd), before[2] + int(with_bwd))
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    if with_bwd:
        ref_dq = fa_ops.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, **mask)
        ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, **mask)
        assert dq.dtype == dtype and dq.shape == q.shape
        for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
            torch.testing.assert_close(got.float(), ref.float(), atol=BWD_TOL[dtype],
                                       rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("s,t,causal", [
    (1, 1, True), (63, 63, True), (65, 65, True), (127, 127, True), (129, 129, True),
    (1, 129, False), (65, 63, False), (63, 65, True), (129, 127, True),
])
def test_flash_tc_ragged_below_and_across_one_tile(gen, s, t, causal):
    """S and T below one tile of the tensor-core kernels (128 queries, 128
    keys) and not a multiple of it: TMA fills the rows past the end with
    zeros, which the kernels mask."""
    _flash_case(gen, 2, s, t, 8, 2, 64, causal, None)


@pytest.mark.parametrize("s,t,window", [(200, 300, None), (300, 200, None), (250, 330, 96)])
def test_flash_tc_causal_diagonal_mid_tile_cross_shape(gen, s, t, window):
    """S != T: the causal diagonal (and the window edge) cross key and query
    tiles mid-way."""
    _flash_case(gen, 1, s, t, 8, 2, 64, True, window)
    if window is not None:  # the window without causality
        _flash_case(gen, 1, s, t, 8, 2, 64, False, window)


@pytest.mark.parametrize("hd,s", [(32, 97), (32, 161), (256, 77), (256, 300), (128, 190)])
def test_flash_tc_head_dims_ragged(gen, hd, s):
    """hd 32 (64-byte swizzle) and 256 (four 64-column slabs; the forward's
    64-key tiles, dq's 32-key tiles, dkv's warpgroups that share a 64-key
    tile, its GQA group split across blocks) at ragged lengths, forward and
    backward."""
    h, kv = (16, 1) if hd == 256 else (4, 2)
    _flash_case(gen, 2, s, s, h, kv, hd, True, 128 if hd == 256 else None)


def test_flash_tc_reads_strided_views(gen):
    """q, k and v as slices of wider buffers (a fused projection): strides
    that TMA can take are read in place, with no copy."""
    b, s, h, kv, hd = 2, 150, 8, 2, 64
    qbuf = torch.randn((b, s, h, 2 * hd), generator=gen, device="cuda").bfloat16()
    kvbuf = torch.randn((b, s, 2, kv, hd), generator=gen, device="cuda").bfloat16()
    q, k, v = qbuf[..., hd:], kvbuf[:, :, 0], kvbuf[:, :, 1]
    assert not q.is_contiguous() and not k.is_contiguous()
    _flash_case(gen, b, s, s, h, kv, hd, True, None, q=q, k=k, v=v)


@pytest.mark.parametrize("how", ["stride", "base"])
def test_flash_tc_refuses_what_tma_cannot_read(gen, how):
    """A bf16 CUDA tensor with a row stride that is not a multiple of 16
    bytes, or a base address that is not 16-byte aligned, is refused with
    ValueError: no copy, no fallback, no launch."""
    b, s, h, kv, hd = 1, 64, 4, 2, 64
    k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").bfloat16()
    if how == "stride":
        q = torch.randn((b, s, h, hd + 4), generator=gen, device="cuda").bfloat16()[..., :hd]
    else:
        flat = torch.randn((b * s * h * hd + 1,), generator=gen, device="cuda").bfloat16()
        q = flat[1:].view(b, s, h, hd)
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    lse = torch.zeros((b, h, s), device="cuda")
    before = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches)
    with pytest.raises(ValueError, match="TMA"):
        fa_ops.flash_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="TMA"):
        fa_ops.flash_bwd_dq(q, k, v, do, lse, lse, causal=True)
    with pytest.raises(ValueError, match="TMA"):
        fa_ops.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True)
    assert (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches) == before


def test_flash_autograd_runs_the_kernels(gen):
    q, k, v = (torch.randn((1, 256, s, 64), generator=gen, device="cuda").bfloat16()
               .requires_grad_() for s in (8, 2, 2))
    before = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches) == tuple(
        n + 1 for n in before)
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,offset", [
    (4096, 2048, 0), (300, 2048, 0), (16384, 64, 0), (7, 100, 0), (33, 7, 0),
    (512, 4096, 0),   # glm4-9b and minitron-8b d_model: the looped kernel in bf16
    (300, 5120, 0),   # qwen3-14b d_model
    (2048, 128, 0),   # qwen3's qk-norm over head_dim
    (300, 2048, 1),   # rows one element past a 16-byte boundary: one element a lane
    (4096, 1024, 0),  # seamless-m4t-large-v2's d_model, its training rows
])
def test_rmsnorm_bwd_kernel_matches_plain(gen, dtype, n, d, offset):
    def rows():
        flat = torch.randn((n * d + offset,), generator=gen, device="cuda").to(dtype)
        return flat[offset:].view(n, d)

    x = rows()
    w = torch.randn((d,), generator=gen, device="cuda").to(dtype)
    dy = rows()
    before = rn_ops.bwd_launches
    dx, dw = rn_ops.rms_norm_bwd(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert rn_ops.bwd_launches == before + 1
    assert dx.dtype == dtype and dw.dtype == torch.float32 and dw.shape == (d,)
    ref_dx, ref_dw = rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5)
    tol_dx, tol_dw = (2e-2, 3e-2) if dtype == torch.bfloat16 else (2e-5, 2e-4)
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol_dx, rtol=tol_dx)
    torch.testing.assert_close(dw, ref_dw, atol=tol_dw, rtol=tol_dw)
    # the two-stage dw reduction has a fixed order: bit-identical on a rerun
    assert torch.equal(rn_ops.rms_norm_bwd(x, w, dy, 1e-5)[1], dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,offset", [
    (4096, 4096, 0),   # recurrentgemma-9b's d_model: 16 accesses a lane in registers
    (333, 4096, 0),    # rows that fill no whole block
    (517, 2048, 0),    # d_model 2048, rows past a multiple of the block's 8
    (1001, 64, 0),     # rwkv6's group norm: 16 rows a warp, the last warp partial
    (16387, 64, 0),
    (5, 8192, 0),      # bf16: 1024 accesses, four warps a row; f32: the looped kernel
    (300, 2048, 1),    # rows one element past a 16-byte boundary: the looped kernel
    (77, 64, 1),       # unaligned and narrow: one element a lane, in registers
    (9, 100, 0),       # D % VEC != 0
    # past 512 accesses (bf16 4104-8192, f32 2052-4096): four warps a row
    # where 16-byte accesses reach, at a decode step's rows, 1 and 5120 rows
    *((n, d, 0) for d in (2052, 4096, 4104, 6144, 8192) for n in (1, 4, 5120)),
    (768, 6144, 1),    # internvl2-26b's width, unaligned: the looped kernel
])
def test_rmsnorm_fwd_register_rows_match_plain(gen, dtype, n, d, offset):
    """The forward keeps each row in registers between its sum of squares
    and its store (rows of up to 512 accesses in a warp, several rows a warp
    when narrow; up to 1024 in four warps): every width and row count the
    plan cuts, and unaligned views, agree with the plain version, in one
    launch a call."""
    flat = torch.randn((n * d + offset,), generator=gen, device="cuda").to(dtype)
    x = flat[offset:].view(n, d)
    w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
    before = rn_ops.launches
    y = rn_ops.rms_norm_fwd(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn_ops.launches == before + 1
    assert rn_ops.fwd_kernel_info(x, w)["launches"] == 1
    torch.testing.assert_close(y.float(), rn_ops.rms_norm_plain(x, w, 1e-5).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(rn_ops.rms_norm_fwd(x, w, 1e-5), y)


@pytest.mark.parametrize("dtype,d,offset,kernel", [
    (torch.bfloat16, 4096, 0, "rows"),     # 512 accesses: one warp a row
    (torch.bfloat16, 4104, 0, "group"),    # 513 accesses
    (torch.bfloat16, 6144, 0, "group"),    # internvl2-26b's d_model
    (torch.bfloat16, 8192, 0, "group"),    # 1024 accesses
    (torch.bfloat16, 8200, 0, "loop"),     # 1025 accesses
    (torch.bfloat16, 6144, 1, "loop"),     # unaligned: one element a lane
    (torch.float32, 2048, 0, "rows"),
    (torch.float32, 2052, 0, "group"),
    (torch.float32, 4096, 0, "group"),
    (torch.float32, 4100, 0, "loop"),
])
def test_rmsnorm_fwd_plan_picks_the_kernel_by_row_accesses(gen, dtype, d, offset, kernel):
    """Rows of up to 512 16-byte accesses go to the one-warp register
    kernel, 513-1024 to four warps a row, wider rows and unaligned views to
    the looped kernel; each agrees with the plain version at 4 and 5120 rows
    (a decode step spreads over at least four blocks of one group)."""
    for n in (4, 5120):
        flat = torch.randn((n * d + offset,), generator=gen, device="cuda").to(dtype)
        x = flat[offset:].view(n, d)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
        plan = rn_ops.fwd_kernel_info(x, w)
        assert plan["kernel"] == kernel and plan["local_bytes"] == 0
        if kernel == "group":
            assert plan["threads"] % 128 == 0 and plan["blocks"] * plan["threads"] >= 128 * n
        y = rn_ops.rms_norm_fwd(x, w, 1e-5)
        torch.testing.assert_close(y.float(), rn_ops.rms_norm_plain(x, w, 1e-5).float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


#: the main paths' attention heads (H, KV, hd) at head_dim 64 and 128
FWD_FAMILIES = {"vlm": (48, 8, 128), "moonshot": (16, 16, 128), "encdec": (16, 16, 64),
                "llama": (32, 8, 64)}


def _fwd_repeats(gen, b, s, t, h, kv, hd, causal, window):
    """The bf16 forward against its plain version in one launch, and a
    second call giving the same bits."""
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").bfloat16()
    before = fa_ops.launches
    out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, causal=causal, window=window)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    out2, lse2 = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1280])
@pytest.mark.parametrize("family", list(FWD_FAMILIES))
def test_flash_fwd_families_match_plain_and_repeat(gen, family, s):
    """The pipelined bf16 forward at each main path's heads (encdec's not
    causal), S = T below, at and across one 64-key tile and at vlm's
    training length, where causal blocks end with a key tile that
    warpgroup 0 sees nothing of."""
    h, kv, hd = FWD_FAMILIES[family]
    _fwd_repeats(gen, 1 if s == 1280 else 2, s, s, h, kv, hd, family != "encdec", None)


@pytest.mark.parametrize("s,t,causal,window", [
    (200, 330, False, None),   # S != T, not causal
    (330, 200, False, None),
    (512, 512, True, 128),     # window 128: warpgroup 1 skips the block's first key tile
    (300, 300, False, 128),    # the window without causality
    (256, 256, True, None),    # causal: warpgroup 0 sees nothing of the last key tile
    (129, 129, True, None),    # a second query tile of one row
])
@pytest.mark.parametrize("family", list(FWD_FAMILIES))
def test_flash_fwd_families_masks_match_plain_and_repeat(gen, family, s, t, causal, window):
    """The pipelined bf16 forward under every mask the paths use, at each
    main path's heads."""
    h, kv, hd = FWD_FAMILIES[family]
    _fwd_repeats(gen, 2, s, t, h, kv, hd, causal, window)


@pytest.mark.parametrize("b,s,t,h,kv,causal,window", [
    (1, 1024, 1024, 16, 1, True, 512),   # recurrentgemma-9b's 16/1 heads: split 16
    (1, 300, 300, 16, 1, True, 128),     # ragged, the window bites
    (1, 640, 640, 4, 1, True, None),     # group 4: split 4
    (2, 300, 300, 4, 2, True, 128),      # group 2, two KV heads, two batch rows
    (1, 200, 330, 8, 1, True, 96),       # ragged T past S
    (1, 256, 256, 8, 2, False, None),    # no mask, group 4
    (1, 512, 512, 1, 1, True, None),     # group 1: nothing to split
])
def test_flash_bwd_dkv_hd256_split_matches_plain_and_repeats(gen, b, s, t, h, kv, causal,
                                                             window):
    """The bf16 dkv kernel at head_dim 256 with the GQA group split across
    blocks (where its planner splits it) agrees with the plain version, and
    the fixed-order sum of the splits gives the same bits on a second call."""
    dtype, hd = torch.bfloat16, 256
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    mask = dict(causal=causal, window=window)
    out, lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    plan = fa_ops.dkv_plan(b, t, kv, h // kv, hd, dtype,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan["split"] > 1 or h == kv
    before = fa_ops.dkv_launches
    dk, dv = fa_ops.flash_bwd_dkv(q, k, v, do, lse, delta, **mask)
    again = fa_ops.flash_bwd_dkv(q, k, v, do, lse, delta, **mask)
    torch.cuda.synchronize()
    assert fa_ops.dkv_launches == before + 2
    ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **mask)
    for got, ref, rerun in ((dk, ref_dk, again[0]), (dv, ref_dv, again[1])):
        assert got.dtype == dtype and got.shape == (b, t, kv, hd)
        torch.testing.assert_close(got.float(), ref.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])
        assert torch.equal(got, rerun)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,split", [
    (1, 1024, 1024, 32, 8, True, None, None),  # the pipeline's microbatch: split 4
    (2, 1024, 1024, 16, 4, True, None, None),  # a TP rank's shard: split 4
    (1, 1024, 1024, 32, 8, True, None, 1),     # the same, forced unsplit
    (1, 1024, 1024, 32, 8, True, None, 2),     # and at a split of 2
    (1, 333, 333, 8, 2, True, 128, None),      # ragged (S % 4 != 0), the window bites
    (1, 200, 330, 8, 1, True, 96, None),       # ragged T past S, MQA: split 8
    (2, 301, 301, 4, 4, False, 64, None),      # group 1, window without causality
    (4, 300, 300, 32, 8, True, None, None),    # training at batch 4, ragged: unsplit
    (1, 256, 256, 8, 2, False, None, 2),       # no mask, group 4, split 2
])
def test_flash_bwd_dkv_split_matches_plain_and_repeats(gen, monkeypatch, hd, b, s, t, h, kv,
                                                      causal, window, split):
    """The bf16 dkv kernel at head_dim 64 and 128, unsplit and with the GQA
    group split across blocks (the planner's split, or one forced by
    replacing it), agrees with the plain version, and gives the same bits on
    a second call."""
    dtype = torch.bfloat16
    if split is not None:
        monkeypatch.setattr(fa_ops, "dkv_split", lambda *_: split)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
    mask = dict(causal=causal, window=window)
    out, lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    plan = fa_ops.dkv_plan(b, t, kv, h // kv, hd, dtype,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan["blocks"] == -(-t // 64) * kv * b * plan["split"]
    before = fa_ops.dkv_launches
    dk, dv = fa_ops.flash_bwd_dkv(q, k, v, do, lse, delta, **mask)
    again = fa_ops.flash_bwd_dkv(q, k, v, do, lse, delta, **mask)
    torch.cuda.synchronize()
    assert fa_ops.dkv_launches == before + 2
    ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **mask)
    for got, ref, rerun in ((dk, ref_dk, again[0]), (dv, ref_dv, again[1])):
        assert got.dtype == dtype and got.shape == (b, t, kv, hd)
        torch.testing.assert_close(got.float(), ref.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])
        assert torch.equal(got, rerun)


def test_flash_bwd_dkv_reads_unaligned_lse(gen):
    """lse and delta that start off a 16-byte boundary (views into a larger
    buffer) are copied before the kernel reads them by TMA."""
    dtype, (b, s, h, kv, hd) = torch.bfloat16, (1, 130, 4, 2, 64)
    q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = fa_ops.flash_fwd_plain(q, k, v, causal=True, window=None)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    shifted = [torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x).copy_(x)
               for x in (lse, delta)]
    assert all(x.data_ptr() % 16 for x in shifted)
    dk, dv = fa_ops.flash_bwd_dkv(q, k, v, do, *shifted, causal=True)
    torch.cuda.synchronize()
    ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True,
                                                window=None)
    torch.testing.assert_close(dk.float(), ref_dk.float(), atol=BWD_TOL[dtype],
                               rtol=BWD_TOL[dtype])
    torch.testing.assert_close(dv.float(), ref_dv.float(), atol=BWD_TOL[dtype],
                               rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("qk_norm", [False, True])
def test_kernel_path_loss_gives_every_leaf_a_gradient(gen, qk_norm):
    """A loss through ``attn_impl="pallas"`` / ``norm_impl="fused"`` on the
    card differentiates through the kernels: every parameter leaf gets a
    finite, nonzero gradient, within f32 tolerance of the plain path's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as PM
    from repro_torch.models.layers import tree_leaves, tree_map

    base = get_smoke_config("llama3.2-1b").replace(dtype="float32", use_qk_norm=qk_norm)
    params = PM.init_params(base, gen, device="cuda")
    tokens = torch.randint(0, base.vocab_size, (2, 128), generator=gen, device="cuda",
                           dtype=torch.int32)
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    batch = {"tokens": tokens, "targets": targets}
    grads = {}
    for impl, cfg in (("kernel", base.replace(attn_impl="pallas", norm_impl="fused")),
                      ("plain", base.replace(attn_impl="chunked", norm_impl="ref"))):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        before = (fa_ops.launches, fa_ops.dq_launches, rn_ops.bwd_launches)
        loss, _ = PM.loss_fn(cfg, live, batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        after = (fa_ops.launches, fa_ops.dq_launches, rn_ops.bwd_launches)
        moved = [a > b for a, b in zip(after, before)]
        assert all(moved) if impl == "kernel" else not any(moved), (impl, before, after)
    for g, ref in zip(grads["kernel"], grads["plain"]):
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0
        rel = ((g - ref).norm() / ref.norm()).item()
        assert rel < 1e-3, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,with_h0,strided", [
    (1, 2560, 4096, True, False),   # recurrentgemma-9b's prefill shape
    (1, 300, 4096, False, False),   # ragged S
    (4, 1024, 4096, True, False),
    (2, 37, 100, True, True),       # ragged D, inputs read through strides
])
def test_rglru_kernel_matches_plain(gen, dtype, b, s, d, with_h0, strided):
    step = 2 if strided else 1
    a = torch.sigmoid(torch.randn((b, s * step, d), generator=gen, device="cuda"))
    a = a.to(dtype)[:, ::step]
    x = torch.randn((b, s * step, d), generator=gen, device="cuda").to(dtype)[:, ::step]
    h0 = torch.randn((b, d), generator=gen, device="cuda") if with_h0 else None
    before = rg_ops.launches
    y, h = rg_ops.rglru_fwd(a, x, h0)
    torch.cuda.synchronize()
    assert rg_ops.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (b, d)
    ref_y, ref_h = rg_ops.rglru_fwd_plain(a, x, h0)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(h, ref_h, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,k,with_state", [
    (1, 512, 32, 64, True),    # rwkv6-1.6b's prefill shape
    (1, 300, 32, 64, False),   # ragged S
    (2, 64, 4, 16, True),      # the smoke head size
    (1, 100, 2, 32, True),
])
def test_wkv6_kernel_matches_plain(gen, dtype, b, s, h, k, with_state):
    def act():  # read through the strides of a (B, S, H*K) projection's view
        return torch.randn((b, s, h * k), generator=gen, device="cuda").to(dtype).view(b, s, h, k)

    r, kk, v = act(), act(), act()
    w = torch.exp(-torch.exp(torch.randn((b, s, h, k), generator=gen, device="cuda")))
    u = torch.randn((h, k), generator=gen, device="cuda")
    state = torch.randn((b, h, k, k), generator=gen, device="cuda") if with_state else None
    before = wk_ops.launches
    y, s_out = wk_ops.wkv6_fwd(r, kk, v, w, u, state)
    torch.cuda.synchronize()
    assert wk_ops.launches == before + 1
    assert y.dtype == dtype and s_out.dtype == torch.float32
    ref_y, ref_s = wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(s_out, ref_s, atol=2e-5, rtol=2e-5)


def _decays(gen, shape, decay):
    """Per-step decays in (0, 1): "mixed" exp(-exp(N(0, 1))) (the card check's
    draw, one step's log-decay down to about -20), "strong" log-decay about
    -50 a step, "weak" about -0.0025 a step (the state barely decays)."""
    z = torch.randn(shape, generator=gen, device="cuda")
    if decay == "strong":
        return torch.exp(-50.0 + z)
    if decay == "weak":
        return torch.exp(-torch.exp(z - 6.0))
    return torch.exp(-torch.exp(z))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 31, 33, 65, 127, 129, 300])
@pytest.mark.parametrize("decay", ["mixed", "strong", "weak"])
def test_rglru_kernel_chunk_edges(gen, dtype, s, decay):
    """Lengths around the kernel's 16-step sub-chunks and 128-step chunks, a
    batch of 4, a ragged channel count, and decays from ~e^-50 to ~1."""
    b, d = 4, 100
    a = _decays(gen, (b, s, d), decay).to(dtype)
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    before = rg_ops.launches
    y, h = rg_ops.rglru_fwd(a, x, h0)
    torch.cuda.synchronize()
    assert rg_ops.launches == before + 1
    ref_y, ref_h = rg_ops.rglru_fwd_plain(a, x, h0)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(h, ref_h, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 31, 33, 65])
@pytest.mark.parametrize("k,decay", [(64, "mixed"), (64, "strong"), (64, "weak"),
                                     (16, "strong"), (32, "weak")])
def test_wkv6_kernel_chunk_edges(gen, dtype, s, k, decay):
    """Lengths around the kernel's 32-step chunks, a batch of 4, and decays
    from ~e^-50 a step (whose pairwise exponents would overflow if factored)
    to ~1 (the state keeps every step)."""
    b, h = 4, 3
    r, kk, v = (torch.randn((b, s, h, k), generator=gen, device="cuda").to(dtype)
                for _ in range(3))
    w = _decays(gen, (b, s, h, k), decay)
    u = torch.randn((h, k), generator=gen, device="cuda")
    state = torch.randn((b, h, k, k), generator=gen, device="cuda")
    before = wk_ops.launches
    y, s_out = wk_ops.wkv6_fwd(r, kk, v, w, u, state)
    torch.cuda.synchronize()
    assert wk_ops.launches == before + 1
    ref_y, ref_s = wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s_out).all())
    if dtype == torch.float32 and decay == "weak":
        # decays near 1 keep every step in the state, and the f32 plain loop's
        # own rounding at elements where the 64-term dot product cancels is
        # above the f32 tolerance, so no other summation order can meet it
        # against that loop: y is held against the recurrence in f64, to the
        # tolerance beyond the plain loop's own error, and that error may
        # not pass WEAK_SLACK, so the allowance has a fixed ceiling
        truth = _wkv6_f64(r, kk, v, w, u, state)
        slack = (ref_y.double() - truth).abs().max().item()
        assert slack <= WEAK_SLACK, slack
        torch.testing.assert_close(y.double(), truth, atol=TOL[dtype] + slack, rtol=TOL[dtype])
    else:
        torch.testing.assert_close(y.float(), ref_y.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(s_out, ref_s, atol=2e-5, rtol=2e-5)


#: ceiling of the f32 plain WKV-6 loop's own error against the f64
#: recurrence in the decays-near-1 case: 5x the f32 tolerance (|y| reaches
#: ~250 there, where one f32 ulp is 1.5e-5)
WEAK_SLACK = 5 * TOL[torch.float32]


def _wkv6_f64(r, k, v, w, u, state):
    """y of the WKV-6 recurrence, step by step in f64."""
    r, k, v, w, u, s = (x.double() for x in (r, k, v, w, u, state))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrence_kernels_refuse_backward(gen, arch):
    """The recurrence kernels have no backward yet: a loss on the card
    through ``seq_impl="pallas"`` raises instead of training nothing through
    the recurrence; ``seq_impl="parallel"`` gives every leaf a gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as PM
    from repro_torch.models.layers import tree_leaves, tree_map

    cfg = get_smoke_config(arch).replace(dtype="float32", attn_impl="pallas", norm_impl="fused")
    params = PM.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device="cuda",
                           dtype=torch.int32)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    for seq_impl in ("pallas", "parallel"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss, _ = PM.loss_fn(cfg.replace(seq_impl=seq_impl), tree_map(lambda _: next(it), params),
                             batch)
        if seq_impl == "pallas":
            with pytest.raises(NotImplementedError, match="no backward kernel"):
                torch.autograd.grad(loss, leaves)
        else:
            grads = torch.autograd.grad(loss, leaves)
            assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_smoke_config_serves_through_the_kernels(gen, dtype):
    """moonshot-v1-16b-a3b's smoke config (4/4 heads of 16, 8 experts, top 2)
    served on the card with ``attn_impl="pallas"``, ``norm_impl="fused"``:
    one flash launch per layer and prefill, two RMSNorm launches per layer
    and call, and every prompt's prefill logits against the plain path.  In
    f32 the two paths route every token alike and agree elementwise at 2e-4.
    In bf16 a near-tie between a token's 2nd and 3rd gate can flip its
    choice between the paths, and under capacity the drops after it, and
    one expert is half a token's MoE output; so there the plain path
    replays the kernel path's routing, layer by layer, and the logits are
    held at the repo's bf16 model tolerance (atol 0.1, rtol 0.05)."""
    import numpy as np

    from repro_torch.launch.serve import make_requests, run_serving
    from repro_torch.models import model as PM
    from repro_torch.models import moe

    prompt_lens, n_requests = [128, 40], 4
    before = (fa_ops.launches, rn_ops.launches)
    engine = run_serving("moonshot-v1-16b-a3b", n_requests, prompt_lens, 8, n_slots=2,
                         seed=0, smoke=True, attn_impl="pallas", norm_impl="fused",
                         dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    cfg = engine.cfg
    assert cfg.moe is not None and len(engine.completed) == n_requests
    flash, norms = fa_ops.launches - before[0], rn_ops.launches - before[1]
    assert flash == cfg.n_layers * n_requests
    assert norms % (2 * cfg.n_layers) == 0 and norms > 2 * cfg.n_layers * n_requests
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    requests = make_requests(cfg.vocab_size, n_requests, prompt_lens, 8, np.random.default_rng(0))
    route = moe.route
    for req, res in zip(requests, sorted(engine.completed, key=lambda r: r.rid)):
        tokens = torch.tensor([req.prompt], dtype=torch.int32, device="cuda")
        logits, routings = [], ([], [])
        replays = (None, routings[0] if dtype == "bfloat16" else None)
        for c, seen, replay in zip((cfg, plain), routings, replays):

            def recording(*args, seen=seen, replay=replay):
                seen.append(route(*args))
                return seen[-1] if replay is None else replay[len(seen) - 1]

            moe.route = recording
            try:
                cache = PM.init_cache(c, 1, engine.max_seq, device="cuda")
                logits.append(PM.prefill(c, engine.params, {"tokens": tokens}, cache)[1][0].float())
            finally:
                moe.route = route
        assert int(logits[0][: cfg.vocab_size].argmax()) == res.tokens[0]
        if dtype == "float32":
            for kernel_r, plain_r in zip(*routings):
                assert torch.equal(kernel_r.mask, plain_r.mask)
            torch.testing.assert_close(logits[0], logits[1], atol=2e-4, rtol=2e-4)
        else:
            torch.testing.assert_close(logits[0], logits[1], atol=0.1, rtol=0.05)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encdec_smoke_config_runs_through_the_kernels(gen, dtype):
    """seamless-m4t-large-v2's smoke config (2 + 2 layers, 4/4 heads of 16)
    on the card with ``attn_impl="pallas"``, ``norm_impl="fused"``, from
    random source frames of another length than the prompt: a prefill
    launches three flash kernels a decoder layer and one an encoder layer
    (the encoder's and the cross-attention's not causal), and its logits
    and a decode step's hold against the plain path (f32 at 2e-4, bf16 at
    the repo's model tolerance, atol 0.1, rtol 0.05); the loss's gradient
    reaches every leaf, the encoder's included, through the flash
    backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as PM
    from repro_torch.models.layers import tree_leaves, tree_map

    cfg = get_smoke_config("seamless-m4t-large-v2").replace(
        attn_impl="pallas", norm_impl="fused", dtype=dtype)
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    params = PM.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen, device="cuda")
    frames = 0.02 * torch.randn((2, 77, cfg.d_model), generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :40], "src_frames": frames}
    tol = dict(atol=2e-4, rtol=2e-4) if dtype == "float32" else dict(atol=0.1, rtol=0.05)
    n_flash = cfg.n_enc_layers + 2 * cfg.n_layers
    logits, launched = [], []
    for c in (cfg, plain):
        before = fa_ops.launches
        cache, first = PM.prefill(c, params, batch, PM.init_cache(c, 2, 96, device="cuda"))
        _, step = PM.decode_step(c, params, cache, tokens[:, 40:])
        torch.cuda.synchronize()
        launched.append(fa_ops.launches - before)
        logits.append((first.float(), step.float()))
    assert launched == [n_flash, 0]
    for got, want in zip(*logits):
        torch.testing.assert_close(got, want, **tol)
    before = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = PM.loss_fn(cfg.replace(remat="none"), live,
                         dict(batch, targets=tokens[:, 1:41]))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert (fa_ops.launches - before[0], fa_ops.dq_launches - before[1],
            fa_ops.dkv_launches - before[2]) == (n_flash, n_flash, n_flash)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pipeline_ranks_share_the_card(gen, dtype):
    """The 1F1B pipeline of llama3.2-1b's width cut to 8 layers on 4 ranks
    that share the card (an explicit ``Mesh`` repeating it), 4 microbatches
    of 1 x 256: per call 2LM flash forwards, LM dq and dkv, 4LM + M RMSNorm
    forwards and 2LM + M backwards; a restaged plan (padded slots) gives
    the same bits and launches as the equal plan; and the loss and every
    leaf hold against the non-pipelined kernel path (f32 at 2e-4, bf16 at
    10% relative norm a leaf)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.meshutil import Mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.models import model as PM
    from repro_torch.models.layers import tree_leaves, tree_map

    n_layers, n_micro = 8, 4
    cfg = get_config("llama3.2-1b").replace(attn_impl="pallas", norm_impl="fused",
                                            dtype=dtype, n_layers=n_layers)
    plan = StagePlan.equal(range(4), n_layers)
    built = make_transformer_pipeline_train_step(
        cfg, Mesh([torch.device("cuda", 0)] * 4, ("pod",)), plan, seq_len=256,
        global_batch=n_micro, n_micro=n_micro, device="cuda")
    params = built.init_params(gen)
    batch = {k: torch.randint(0, cfg.vocab_size, (n_micro, 256), generator=gen, device="cuda")
             for k in ("tokens", "targets")}
    counters = [(fa_ops, "launches"), (fa_ops, "dq_launches"), (fa_ops, "dkv_launches"),
                (rn_ops, "launches"), (rn_ops, "bwd_launches")]
    runs = []
    for weight in (1.0, 0.1):
        plan.set_weight(1, weight)
        before = [getattr(m, a) for m, a in counters]
        loss, grads = built.pipeline_call(params, batch)
        torch.cuda.synchronize()
        runs.append((loss, tree_leaves(grads),
                     [getattr(m, a) - b for (m, a), b in zip(counters, before)]))
    assert plan.max_depth() == 3
    lm = n_layers * n_micro
    assert runs[0][2] == runs[1][2] == [2 * lm, lm, lm, 4 * lm + n_micro, 2 * lm + n_micro]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    ref_loss, _ = PM.loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    ref = torch.autograd.grad(ref_loss, leaves)
    loss, grads, _ = runs[0]
    if dtype == "float32":
        assert abs(loss.item() - ref_loss.item()) <= 2e-4
        for g, r in zip(grads, ref):
            torch.testing.assert_close(g, r, atol=2e-4, rtol=0)
    else:
        assert abs(loss.item() - ref_loss.item()) <= 3e-2 * abs(ref_loss.item())
        for g, r in zip(grads, ref):
            assert ((g.float() - r.float()).norm() / r.float().norm()).item() < 0.1


def _sharded_step_worker(rank, world, dtype):
    """One rank of a (1, 2) ("data", "model") mesh sharing the card: the
    llama smoke config's gradient and three AdamW steps, sharded (heads,
    FFN and vocabulary over "model": 2/1 heads a rank) and unsharded."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.context import use_sharding
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.sharding import Axes, distribute_tree, gather_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as PM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = device_mesh((1, 2), ("data", "model"), device="cuda", allow_shared_card=True)
    cfg = get_smoke_config("llama3.2-1b").replace(attn_impl="pallas", norm_impl="fused",
                                                  remat="dots", dtype=dtype)
    rules = ST.rules_for(cfg)
    shape = ShapeConfig("t", "train", 128, 2)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, 128, 2, mode="copy", seed=0), arch=cfg)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
               for i in range(3)]
    axes = {k: Axes(v) for k, v in ST.batch_axes(cfg, "train").items()}
    params = PM.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ref_grads, _ = ST._grads(cfg, params, batches[0])
    sp = distribute_tree(params, PM.param_axes(cfg), mesh, rules)
    launches = fa_ops.launches
    with use_sharding(mesh, rules):
        g, _ = ST._grads(cfg, sp, distribute_tree(batches[0], axes, mesh, rules))
        g = tree_map(lambda gg, p: gg.redistribute(p.device_mesh, p.placements), g, sp)
    launches = fa_ops.launches - launches
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(tree_leaves(gather_tree(g)), tree_leaves(ref_grads))]
    losses = []
    for mesh_arg, tree in ((None, params), (mesh, sp)):
        step = ST.make_train_step(cfg, shape, warmup_steps=1, total_steps=10, mesh=mesh_arg,
                                  rules=rules)
        p, st, run = tree, init_opt_state(AdamWConfig(), tree), []
        for b in batches:
            b = b if mesh_arg is None else distribute_tree(b, axes, mesh, rules)
            p, st, m = step.fn(p, st, b)
            run.append(float(m["loss"]))
        losses.append(run)
    return {"rel": rel, "losses": losses, "launches": launches}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_on_two_ranks_sharing_the_card(gen, dtype):
    """A 2-rank (1, 2) mesh on one card (gloo) against the unsharded step:
    the kernels run on each rank's 2 of the 4 heads (one flash forward a
    layer and again in the remat recompute)."""
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.kernels import build

    build.build_all()
    results = run_ranks(_sharded_step_worker, 2, dtype, device="cuda")
    leaf_tol, loss_tol = (1e-4, 1e-5) if dtype == "float32" else (0.1, 3e-2)
    for r in results:
        assert r["launches"] == 2 * 2  # two layers, forward and recompute
        assert max(r["rel"]) < leaf_tol, r["rel"]
        plain, sharded = r["losses"]
        for a, b in zip(sharded, plain):
            assert abs(a - b) <= loss_tol * abs(b), (sharded, plain)


def _sharded_serve_worker(rank, world, arch):
    """One rank of a (1, 2) ("data", "model") mesh sharing the card: the
    smoke config's sharded prefill and one decode step (``make_prefill_step``
    / ``make_serve_step``, f32) against the unsharded port, and the
    launches of each kernel in each call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as PM
    from repro_torch.models.config import ShapeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = device_mesh((1, 2), ("data", "model"), device="cuda", allow_shared_card=True)
    cfg = get_smoke_config(arch).replace(attn_impl="pallas", norm_impl="fused",
                                         seq_impl="pallas", dtype="float32")
    rules = ST.rules_for(cfg)
    params = PM.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).cuda()
    mods = (fa_ops, rn_ops, rg_ops, wk_ops)

    def counted(fn, *args):
        before = [m.launches for m in mods]
        out = fn(*args)
        torch.cuda.synchronize()
        return out, [m.launches - b for m, b in zip(mods, before)]

    outs = []
    for sharded in (False, True):
        cache = PM.init_cache(cfg, 2, 72, device="cuda")
        if sharded:
            pre = ST.make_prefill_step(cfg, mesh, rules, ShapeConfig("p", "prefill", 64, 2)).fn
            dec = ST.make_serve_step(cfg, mesh, rules, ShapeConfig("d", "decode", 72, 2)).fn
        else:
            pre = lambda p, b, c: PM.prefill(cfg, p, b, c)  # noqa: E731
            dec = lambda p, c, t: PM.decode_step(cfg, p, c, t)  # noqa: E731
        with torch.no_grad():
            (cache, last), n_pre = counted(pre, params, {"tokens": tokens[:, :64]}, cache)
            (cache, step), n_dec = counted(dec, params, cache, tokens[:, 64:])
        if sharded:
            last, step = last.full_tensor(), step.full_tensor()
        outs.append((last.cpu(), step.cpu(), n_pre, n_dec))
    (l0, s0, p0, d0), (l1, s1, p1, d1) = outs
    rel = [((a - b).norm() / b.norm()).item() for a, b in ((l1, l0), (s1, s0))]
    return {"rel": rel, "launches": (p0, d0, p1, d1)}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b", "rwkv6-1.6b"])
def test_sharded_prefill_and_decode_on_two_ranks_sharing_the_card(gen, arch):
    """A 2-rank (1, 2) mesh on one card (gloo): the sharded prefill and decode
    step match the unsharded port in f32, and each rank launches every
    kernel exactly as often as the unsharded path does, on its own shards."""
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.kernels import build

    build.build_all()
    for r in run_ranks(_sharded_serve_worker, 2, arch, device="cuda"):
        assert max(r["rel"]) < 1e-4, r["rel"]
        plain_pre, plain_dec, pre, dec = r["launches"]
        assert pre == plain_pre and dec == plain_dec, r["launches"]
        assert sum(pre) > 0 and sum(dec) > 0


def _pipeline_procs_worker(rank, world, dtype):
    """One process of a 2-stage 1F1B pipeline on the card (gloo, the ring
    messages staged through pinned host memory): the llama smoke config cut
    to 4 layers, its loss, gradient share and one AdamW step, gathered to
    rank 0, and this process's flash launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.optim import AdamWConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = device_mesh((world,), ("pod",), device="cuda", allow_shared_card=True)
    cfg = get_smoke_config("llama3.2-1b").replace(attn_impl="pallas", norm_impl="fused",
                                                  dtype=dtype, n_layers=4)
    built = make_transformer_pipeline_train_step(
        cfg, mesh, StagePlan.equal(range(world), 4), seq_len=128, global_batch=4, n_micro=4,
        device="cuda", warmup_steps=1, total_steps=10)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, 128, 4, mode="copy", seed=0), arch=cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    params = built.init_params()
    launches = fa_ops.launches
    loss, grads = built.pipeline_call(params, batch)
    launches = fa_ops.launches - launches
    params, opt_state, _ = built.fn(params, init_opt_state(AdamWConfig(), params), batch)
    return {"loss": loss.item(), "grads": built.share.gather(grads, {})[0],
            "params": built.share.gather(params, {})[0], "launches": launches}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_processes_on_the_card_match_the_single_controller(gen, dtype):
    """2 processes sharing the card against the single controller (2 ranks
    of an explicit ``Mesh`` on the card) from the same seed and batch: the
    loss, every gradient leaf and every parameter after one AdamW step bit
    for bit; each process launches the flash forward for its 2 layers at 4
    microbatches, at the forward tick and in the recompute."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.meshutil import Mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state

    build.build_all()
    results = run_ranks(_pipeline_procs_worker, 2, dtype, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("llama3.2-1b").replace(attn_impl="pallas", norm_impl="fused",
                                                  dtype=dtype, n_layers=4)
    built = make_transformer_pipeline_train_step(
        cfg, Mesh([torch.device("cuda", 0)] * 2, ("pod",)), StagePlan.equal(range(2), 4),
        seq_len=128, global_batch=4, n_micro=4, device="cuda", warmup_steps=1, total_steps=10)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, 128, 4, mode="copy", seed=0), arch=cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    params = built.init_params()
    loss, grads = built.pipeline_call(params, batch)
    params, _, _ = built.fn(params, init_opt_state(AdamWConfig(), params), batch)
    lead = results[0]
    assert lead["loss"] == loss.item()
    for got, want in ((lead["grads"], grads), (lead["params"], params)):
        flat, ref = tree_leaves(got), tree_leaves(want)
        assert len(flat) == len(ref)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(flat, ref))
    assert [r["launches"] for r in results] == [2 * 2 * 4] * 2


def _example(name):
    """``examples/<name>.py`` as a module (the directory is not a package)."""
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses resolve their annotations there
    spec.loader.exec_module(module)
    return module


def test_amr_example_on_the_card(gen, tmp_path):
    """The AMR demonstration briefly on the card (24 iterations: one level):
    the fixed run writes at iterations 8 and 16, the adaptive run fewer
    checkpoints (its first, with no history, at iteration 0) and fewer
    seconds of them."""
    amr = _example("amr_adaptive_checkpoint_torch")
    res = {mode: amr.run_experiment(amr.AMRSettings(
        mode=mode, iterations=24, device="cuda", ckpt_dir=str(tmp_path / "amr")))
        for mode in ("fixed", "adaptive")}
    fixed, adaptive = res["fixed"], res["adaptive"]
    assert fixed["n_checkpoints"] == 2 and fixed["final_levels"] == adaptive["final_levels"] == 1
    assert 1 <= adaptive["n_checkpoints"] < fixed["n_checkpoints"]
    assert adaptive["checkpoint_seconds"] < fixed["checkpoint_seconds"]


def test_train_example_on_the_card(gen, tmp_path):
    """train_llm's ``--fast`` model (6 layers) for 6 steps through the
    kernels: finite losses and the launches of ``_per_step_launches`` (12
    flash forwards, 6 dq, 6 dkv, 24 RMSNorm forwards and 12 backwards a
    step)."""
    from repro_torch.kernels import build

    build.build_all()
    train = _example("train_llm_torch")
    before = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches, rn_ops.launches,
              rn_ops.bwd_launches)
    summary, _ = train.train(["--fast", "--steps", "6", "--batch", "2", "--seq", "64",
                              "--attn-impl", "pallas", "--norm-impl", "fused",
                              "--ckpt-dir", str(tmp_path / "ckpt")])
    after = (fa_ops.launches, fa_ops.dq_launches, fa_ops.dkv_launches, rn_ops.launches,
             rn_ops.bwd_launches)
    assert [b - a for a, b in zip(before, after)] == [6 * n for n in (12, 6, 6, 24, 12)]
    assert summary["iterations"] == 6
    assert torch.isfinite(torch.tensor(summary["final_metrics"]["loss"]))
