"""PyTorch port, flash kernels' shape guard: every config of the port's
registry that has attention blocks, smoke and full width, gets past
``_check``, the refusal the CUDA wrappers apply before a launch, for the
forward and for the backward kernels, at its own head_dim and KV heads.  On
the CPU a wrapper returns its plain version before ``_check`` runs, so a
head_dim the kernels lack shows only here or on the card.
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops

ATTENTION_ARCHS = [arch for arch in ARCH_IDS
                   if any(kind.startswith("attn") for kind in
                          get_smoke_config(arch).block_pattern)]


def test_every_attention_family_has_a_smoke_config():
    assert {"llama3.2-1b", "recurrentgemma-9b"} <= set(ATTENTION_ARCHS)


def _check_both_directions(cfg):
    """q/k/v/do of two short rows at the config's heads: the forward's and
    the backward kernels' ``_check`` (the backward passes ``do`` too)."""
    b, s, hd = 1, 2, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, s, cfg.n_heads, hd), generator=gen).to(dtype)
        k = torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype)
        v = torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype)
        do = torch.randn(q.shape, generator=gen).to(dtype)
        fa_ops._check(q, k, v, cfg.window, head_dims=fa_ops._HEAD_DIMS)
        fa_ops._check(q, k, v, cfg.window, do, head_dims=fa_ops._HEAD_DIMS)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_check_accepts_smoke_config(arch):
    _check_both_directions(get_smoke_config(arch))


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_check_accepts_full_width_config(arch):
    """The published widths: recurrentgemma-9b's 16/1 heads of 256 train
    through the backward kernels, as the reference's do."""
    _check_both_directions(get_config(arch))
