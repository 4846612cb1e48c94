"""PyTorch port, the tensor-core flash kernels' rounding on the CPU.

The bf16 ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels run
their products on the tensor cores, which round what the f32 reference keeps
in f32: P to bf16 before ``P·V`` (forward), dS to bf16 before ``dQ += dS·K``
(dq), P and dS to bf16 before ``dV += Pᵀ·dO`` and ``dK += dSᵀ·Q`` (dkv).  A plain f32 emulation of that rounding, in this file
only, is held against the reference's Pallas kernels in interpret mode (its
untiled fallback where S or T is not a multiple of 128) at the repo's
unchanged bf16 tolerances: out 2e-2, lse 2e-5, gradients 3e-2.  The shapes
are those the CUDA tests give the kernels, at small B and H.

Also here, as pure functions of what they read: the wrappers' TMA guard
(shape, strides, dtype, address) and the kernel build's library name, which
must change when a header a kernel source includes changes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JK
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.bridge import to_torch
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops

OUT_TOL, LSE_TOL, GRAD_TOL = 2e-2, 2e-5, 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, shapes):
    """Same numbers for both frameworks: numpy f32 normals cast to bf16 by
    JAX, then bridged bit-exactly to torch."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jnp.bfloat16)
            for s in shapes]
    return arrs, [to_torch(np.asarray(a)) for a in arrs]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _masked_scores(q, k, causal, window):
    """f32 (B, KV, G, S, T) scores · hd**-0.5 with -inf where masked."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, n_kv, h // n_kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    q_pos = torch.arange(s)[:, None]
    k_pos = torch.arange(t)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return scores.masked_fill(~ok, float("-inf")), ok


#: keys a tile of the bf16 forward kernel by head_dim: `Tiles<HD>::BK` in
#: csrc/flash_attention.cu
FWD_KEY_TILE = {32: 64, 64: 64, 128: 128, 256: 64}


def tc_fwd_emulated(q, k, v, *, causal, window):
    """The bf16 forward kernel's arithmetic: key tiles of FWD_KEY_TILE[hd],
    online softmax in f32, P rounded to bf16 before P·V, the denominator
    from the unrounded P; out in bf16, lse in f32."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    bk = FWD_KEY_TILE[hd]
    scores, _ = _masked_scores(q, k, causal, window)
    vf = v.float()
    m = torch.full(scores.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(scores.shape[:-1] + (hd,))
    for k0 in range(0, t, bk):
        tile = scores[..., k0:k0 + bk]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(tile - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", _bf16(p), vf[:, k0:k0 + bk])
        m = m_new
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, s)
    return out.to(torch.bfloat16), lse


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    """f32 P = exp(s·scale − lse) and dS = P (dP − delta), (B, KV, G, S, T),
    as the backward kernels form them on their accumulators."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scores, _ = _masked_scores(q, k, causal, window)
    p = torch.exp(scores - lse.float().reshape(b, n_kv, g, s, 1))
    dp = torch.einsum("bskgd,btkd->bkgst", do.float().reshape(b, s, n_kv, g, hd), v.float())
    return p, p * (dp - delta.float().reshape(b, n_kv, g, s, 1))


def tc_dkv_emulated(q, k, v, do, lse, delta, *, causal, window):
    """The bf16 dkv kernel's arithmetic: f32 P and dS, both rounded to bf16
    before their products; dk and dv summed over the GQA group in f32,
    returned in bf16."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    qg = q.float().reshape(b, s, n_kv, h // n_kv, hd)
    dog = do.float().reshape(b, s, n_kv, h // n_kv, hd)
    dk = torch.einsum("bkgst,bskgd->btkd", _bf16(ds), qg) * hd ** -0.5
    dv = torch.einsum("bkgst,bskgd->btkd", _bf16(p), dog)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def tc_dq_emulated(q, k, v, do, lse, delta, *, causal, window):
    """The bf16 dq kernel's arithmetic: f32 P and dS, dS rounded to bf16
    before dQ = dS·K·hd**-0.5 is summed in f32; returned in bf16."""
    b, s, h, hd = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bkgst,btkd->bskgd", _bf16(ds), k.float()) * hd ** -0.5
    return dq.reshape(b, s, h, hd).to(torch.bfloat16)


def _tiles(*lengths):
    return all(n % 128 == 0 for n in lengths)


def _jax_lse(q, k, v, causal, window):
    """lse (B, H, S) of the reference: its kernel where S and T tile, else
    the log-sum-exp of the reference's masked f32 scores."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731 - reference kernel layout
    if _tiles(s, t):
        return JK.flash_fwd(sw(q), sw(k), sw(v), causal=causal, window=window, block_q=128,
                            block_k=128, interpret=True)[1]
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, hd)
    scores = jnp.einsum("bskgd,btkd->bkgst", qg, k, preferred_element_type=jnp.float32)
    q_pos, k_pos = jnp.arange(s)[:, None], jnp.arange(t)[None, :]
    ok = jnp.ones((s, t), bool)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    scores = jnp.where(ok, scores * hd ** -0.5, -jnp.inf)
    return jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# tests/test_torch_cuda.py's forward cases at small B and H:
# (B, S, T, H, KV, hd, causal, window)
FWD_CASES = [
    (1, 512, 512, 4, 1, 64, True, None),      # the llama heads' GQA group of 4
    (1, 300, 300, 4, 1, 64, True, None),      # ragged S = T
    (1, 256, 256, 4, 4, 32, True, 128),       # hd 32, sliding window
    (1, 128, 256, 2, 1, 64, False, None),     # cross shape, MQA
    (1, 100, 100, 4, 2, 128, True, None),     # ragged, wide head
    (1, 512, 512, 2, 1, 256, True, 2048),     # recurrentgemma-9b: MQA, hd 256
    (1, 300, 300, 2, 1, 256, True, 128),      # hd 256, ragged, the window bites
    (1, 200, 200, 6, 1, 128, True, None),     # internvl2-26b's 6:1 GQA across key tiles
    (1, 200, 330, 4, 4, 64, False, None),     # seamless's cross-attention: S != T, not causal
]


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", FWD_CASES)
def test_tc_forward_rounding_meets_bf16_tolerance(b, s, t, h, kv, hd, causal, window):
    (q, k, v), (tq, tk, tv) = _inputs(20, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)])
    ref_out = jax_flash(q, k, v, causal=causal, window=window, interpret=True)
    ref_lse = _jax_lse(q, k, v, causal, window)
    out, lse = tc_fwd_emulated(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, h, s)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), atol=LSE_TOL, rtol=LSE_TOL)


# tests/test_torch_cuda.py's backward cases at small B and H
DKV_CASES = [
    (1, 512, 512, 4, 1, 64, True, None),      # the training heads' GQA group of 4
    (1, 300, 300, 4, 2, 64, True, None),      # ragged S = T
    (1, 256, 256, 4, 4, 32, True, 128),       # sliding window
    (1, 128, 256, 2, 1, 64, False, None),     # cross shape, MQA
    (1, 100, 100, 4, 2, 128, True, None),     # ragged, wide head
    (1, 200, 200, 4, 2, 64, False, 48),       # window without causality
]


@functools.lru_cache(maxsize=None)
def _bwd_case(b, s, t, h, kv, hd, causal, window):
    """One backward case's inputs, shared by the dkv and dq tests: the torch
    q, k, v, do, the reference's lse and delta, and its (dq, dk, dv) from
    ``jax.grad`` through its flash wrapper (its Pallas backward kernels where
    S and T tile, autodiff of its chunked attention elsewhere)."""
    (q, k, v, do), torch_inputs = _inputs(
        21, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, s, h, hd)])

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=causal, window=window, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out = jax_flash(q, k, v, causal=causal, window=window, interpret=True)
    lse = to_torch(np.asarray(_jax_lse(q, k, v, causal, window)))
    delta = torch.from_numpy(np.array(
        jnp.sum(do.astype(jnp.float32) * out.astype(jnp.float32), axis=-1))).transpose(1, 2)
    return torch_inputs, lse, delta, grads


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", DKV_CASES)
def test_tc_dkv_rounding_meets_bf16_gradient_tolerance(b, s, t, h, kv, hd, causal, window):
    """dk, dv of the emulation against ``jax.grad`` through the reference's
    flash wrapper, from the reference's lse and out."""
    (tq, tk, tv, tdo), lse, delta, (_, ref_dk, ref_dv) = _bwd_case(
        b, s, t, h, kv, hd, causal, window)
    dk, dv = tc_dkv_emulated(tq, tk, tv, tdo, lse, delta, causal=causal, window=window)
    assert dk.shape == dv.shape == (b, t, kv, hd)
    np.testing.assert_allclose(_np(dk), _np(ref_dk), atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(_np(dv), _np(ref_dv), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", DKV_CASES)
def test_tc_dq_rounding_meets_bf16_gradient_tolerance(b, s, t, h, kv, hd, causal, window):
    """dq of the emulation against ``jax.grad`` with respect to q through the
    reference's flash wrapper, on the dkv test's cases and inputs."""
    (tq, tk, tv, tdo), lse, delta, (ref_dq, _, _) = _bwd_case(
        b, s, t, h, kv, hd, causal, window)
    dq = tc_dq_emulated(tq, tk, tv, tdo, lse, delta, causal=causal, window=window)
    assert dq.shape == (b, s, h, hd) and dq.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(dq), _np(ref_dq), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq"])
def test_tc_emulation_rounds_where_the_plain_version_does_not(kernel):
    """The emulation is not the plain version under another name: it differs
    from it (by bf16 rounding of P before P·V, or of dS before dS·K) while
    both stay within tolerance."""
    _, (tq, tk, tv, tdo) = _inputs(
        22, [(1, 256, 4, 64), (1, 256, 1, 64), (1, 256, 1, 64), (1, 256, 4, 64)])
    plain_out, plain_lse = fa_ops.flash_fwd_plain(tq, tk, tv, causal=True, window=None)
    if kernel == "flash_fwd":
        out, lse = tc_fwd_emulated(tq, tk, tv, causal=True, window=None)
        assert not torch.equal(out, plain_out)
        torch.testing.assert_close(out.float(), plain_out.float(), atol=OUT_TOL, rtol=OUT_TOL)
        torch.testing.assert_close(lse, plain_lse, atol=LSE_TOL, rtol=LSE_TOL)
        return
    delta = (tdo.float() * plain_out.float()).sum(-1).transpose(1, 2)
    args = (tq, tk, tv, tdo, plain_lse, delta)
    dq = tc_dq_emulated(*args, causal=True, window=None)
    plain_dq = fa_ops.flash_bwd_dq_plain(*args, causal=True, window=None)
    assert not torch.equal(dq, plain_dq)
    torch.testing.assert_close(dq.float(), plain_dq.float(), atol=GRAD_TOL, rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# The TMA guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,strides,expect", [
    ((2, 300, 32, 64), (300 * 32 * 64, 32 * 64, 64, 1), (300 * 32 * 64, 32 * 64, 64)),
    # a slice of a wider buffer (a fused projection): strides as they are
    ((2, 150, 8, 64), (150 * 8 * 128, 8 * 128, 128, 1), (150 * 8 * 128, 8 * 128, 128)),
    # extent-1 batch and head axes: their strides never address memory
    ((1, 512, 1, 256), (7, 256, 3, 1), (512 * 256, 256, 512 * 256)),
])
def test_tma_guard_takes_aligned_layouts(shape, strides, expect):
    assert fa_ops.tma_strides(shape, strides, torch.bfloat16, 0x7F0000001000) == expect


@pytest.mark.parametrize("shape,strides,address,match", [
    ((1, 64, 4, 64), (64 * 4 * 64, 4 * 64, 64, 1), 0x7F0000001002, "aligned base"),
    ((1, 64, 4, 64), (64 * 4 * 68, 4 * 68, 68, 1), 0x7F0000001000, "multiples of 16"),
    ((2, 64, 4, 64), (64 * 4 * 64 + 4, 4 * 64, 64, 1), 0x7F0000001000, "multiples of 16"),
    ((1, 64, 4, 64), (64 * 4 * 128, 4 * 128, 128, 2), 0x7F0000001000, "contiguous head_dim"),
])
def test_tma_guard_refuses_misaligned_layouts(shape, strides, address, match):
    with pytest.raises(ValueError, match=match):
        fa_ops.tma_strides(shape, strides, torch.bfloat16, address)


def test_tma_guard_counts_bytes_not_elements():
    """A row stride of 4 elements is 16 bytes in f32 but 8 in bf16."""
    shape, strides = (1, 8, 2, 4), (8 * 2 * 4, 8, 4, 1)
    assert fa_ops.tma_strides(shape, strides, torch.float32, 0) == (64, 8, 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa_ops.tma_strides(shape, strides, torch.bfloat16, 0)


# ---------------------------------------------------------------------------
# The build's library name covers included headers
# ---------------------------------------------------------------------------

def test_editing_an_included_header_renames_the_library(tmp_path, monkeypatch):
    (tmp_path / "helpers.cuh").write_text("// v1\n#include \"inner.cuh\"\n")
    (tmp_path / "inner.cuh").write_text("// inner v1\n")
    (tmp_path / "kern.cu").write_text("#include <cuda_runtime.h>\n#include \"helpers.cuh\"\n")
    (tmp_path / "other.cu").write_text("// includes nothing local\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._sources(tmp_path / "kern.cu")] == [
        "kern.cu", "helpers.cuh", "inner.cuh"]
    first, other = build._target("kern"), build._target("other")
    assert build._target("kern") == first  # stable while nothing changes
    (tmp_path / "helpers.cuh").write_text("// v2\n#include \"inner.cuh\"\n")
    second = build._target("kern")
    (tmp_path / "inner.cuh").write_text("// inner v2\n")
    third = build._target("kern")
    assert len({first, second, third}) == 3
    assert build._target("other") == other
    assert all(t.name.startswith("kern-") and t.suffix == ".so" for t in (first, second, third))


def test_the_flash_sources_include_the_hopper_header():
    """Both flash sources rebuild when the shared wgmma/TMA header changes."""
    for name in ("flash_attention", "flash_attention_bwd"):
        assert "hopper.cuh" in [p.name for p in build._sources(build.CSRC / f"{name}.cu")]


def test_the_rmsnorm_sources_include_the_rows_header():
    """Both RMSNorm sources rebuild when their shared row-access header
    changes."""
    for name in ("rmsnorm", "rmsnorm_bwd"):
        assert "rows.cuh" in [p.name for p in build._sources(build.CSRC / f"{name}.cu")]
