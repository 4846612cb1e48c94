"""PyTorch port on the card: each CUDA kernel against its plain version, and
the launch counters.  Marked ``cuda``; every test skips where there is no
CUDA device (decided inside the fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops

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
@pytest.mark.parametrize("n,d", [(512, 2048), (4, 2048), (16384, 64), (7, 100)])
def test_rmsnorm_kernel_matches_plain(gen, dtype, n, d):
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((d,), generator=gen, device="cuda").to(dtype)
    before = rn_ops.launches
    y = rn_ops.rms_norm_fused(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn_ops.launches == before + 1
    ref = rn_ops.rms_norm_plain(x, w, 1e-5)
    torch.testing.assert_close(y.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
