"""PyTorch port, flash kernels' shape guard: every smoke config of the port's
registry that has attention blocks gets past ``_check``, the refusal the
CUDA wrappers apply before a launch, for the forward and for the backward
kernels, at its own head_dim and KV heads.  On the CPU a wrapper returns its
plain version before ``_check`` runs, so a head_dim the kernels lack shows
only here or on the card.
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops

ATTENTION_ARCHS = [arch for arch in ARCH_IDS
                   if any(kind.startswith("attn") for kind in
                          get_smoke_config(arch).block_pattern)]


def test_every_attention_family_has_a_smoke_config():
    assert {"llama3.2-1b", "recurrentgemma-9b"} <= set(ATTENTION_ARCHS)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_check_accepts_smoke_config(arch):
    cfg = get_smoke_config(arch)
    b, s, hd = 2, 24, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, s, cfg.n_heads, hd), generator=gen).to(dtype)
        k = torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype)
        v = torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype)
        do = torch.randn(q.shape, generator=gen).to(dtype)
        fa_ops._check(q, k, v, cfg.window)
        fa_ops._check(q, k, v, cfg.window, do, head_dims=fa_ops._BWD_HEAD_DIMS)
