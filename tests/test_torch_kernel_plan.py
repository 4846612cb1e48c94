"""PyTorch port, the bf16 dkv kernel's launch plan: how many blocks each
key tile is split into over the GQA group's query heads,
the grid, the launches a call and the f32 workspace of the split.  The plan
is a pure function of the shapes and the card's SM count, so it is held
here on the CPU; ``tests/test_torch_cuda.py`` holds the kernel that runs it
against its plain version on the card.
"""

import itertools

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

H100_SMS = 132


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _grid(b, t, kv, hd):
    """Blocks of the unsplit tensor-core dkv kernel: one per key tile (128
    keys, 64 at head_dim 256), KV head and batch row."""
    return -(-t // (64 if hd == 256 else 128)) * kv * b


def test_llama_training_shape_is_not_split():
    """llama3.2-1b's training shape (B=4, S=T=1024, 32/8 heads of 64): 8 key
    tiles x 8 KV heads x 4 rows = 256 blocks already fill the card."""
    assert fa_ops.dkv_split(4, 1024, 8, 4, 64, H100_SMS) == 1
    plan = fa_ops.dkv_plan(4, 1024, 8, 4, 64, torch.bfloat16, H100_SMS)
    assert plan == dict(split=1, blocks=256, launches=1, workspace_bytes=0)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("b,t,kv,group", [(1, 300, 1, 16), (1, 4096, 1, 16), (1, 128, 2, 4),
                                          (4, 1024, 8, 4), (2, 37, 1, 2)])
def test_head_dims_below_256_are_never_split(hd, b, t, kv, group):
    assert fa_ops.dkv_split(b, t, kv, group, hd, H100_SMS) == 1
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa_ops.dkv_plan(b, t, kv, group, hd, dtype, H100_SMS)
        assert (plan["split"], plan["launches"], plan["workspace_bytes"]) == (1, 1, 0)


@pytest.mark.parametrize("b,t,kv,group,split", [
    (1, 4096, 1, 16, 8),   # recurrentgemma-9b's training path: 64 blocks -> 512
    (1, 300, 1, 16, 16),   # the ragged case: 5 blocks, at most 80 with the whole group
    (1, 512, 1, 16, 16),   # 8 blocks -> 128: the group does not reach a wave
    (1, 2560, 1, 16, 8),   # the serving prompt's length: 40 -> 320
    (2, 4096, 1, 16, 4),   # two rows: 128 -> 512
    (1, 4096, 2, 4, 4),    # GQA 8/2: 128 blocks, the group allows 512
])
def test_hd256_split_fills_two_waves_where_the_group_allows(b, t, kv, group, split):
    """Under one wave of SMs, the least divisor of the group that makes two
    waves (so that blocks of unequal work balance), else the whole group;
    never fewer than one wave where the group reaches it."""
    got = fa_ops.dkv_split(b, t, kv, group, 256, H100_SMS)
    assert got == split
    blocks = _grid(b, t, kv, 256)
    assert blocks < H100_SMS and group % got == 0 and got <= group
    if blocks * group >= 2 * H100_SMS:
        assert blocks * got >= 2 * H100_SMS
        assert all(blocks * d < 2 * H100_SMS for d in _divisors(group) if 1 < d < got)
    else:
        assert got == group
    plan = fa_ops.dkv_plan(b, t, kv, group, 256, torch.bfloat16, H100_SMS)
    assert plan == dict(split=got, blocks=blocks * got, launches=2,
                        workspace_bytes=2 * got * b * t * kv * 256 * 4)


def test_workspace_of_the_hd256_path():
    """At the path (B=1, T=4096, one KV head) with SPLIT 8: 8 x 4096 x 256
    f32 partials of dk and of dv, 67.11 MB."""
    plan = fa_ops.dkv_plan(1, 4096, 1, 16, 256, torch.bfloat16, H100_SMS)
    assert plan["workspace_bytes"] == 8 * 1 * 4096 * 1 * 256 * 2 * 4 == 67_108_864


def test_split_is_a_divisor_never_above_the_group():
    for b, t, kv, group, sms in itertools.product((1, 2, 4), (1, 77, 128, 300, 1024, 4096),
                                                  (1, 2, 8), (1, 2, 3, 4, 6, 16), (1, 66, 132)):
        split = fa_ops.dkv_split(b, t, kv, group, 256, sms)
        assert 1 <= split <= group and group % split == 0
        blocks = _grid(b, t, kv, 256)
        assert split == 1 if blocks >= sms else (blocks * split >= 2 * sms or split == group)


def test_f32_instances_are_not_split():
    """The f32-FMA dkv kernel (32-key blocks, every head of the group in one
    block) takes no split, at head_dim 256 too."""
    plan = fa_ops.dkv_plan(1, 512, 1, 16, 256, torch.float32, H100_SMS)
    assert plan == dict(split=1, blocks=16, launches=1, workspace_bytes=0)
    plan = fa_ops.dkv_plan(2, 128, 1, 4, 16, torch.bfloat16, H100_SMS)
    assert plan == dict(split=1, blocks=8, launches=1, workspace_bytes=0)
