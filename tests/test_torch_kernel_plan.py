"""PyTorch port, the bf16 dkv kernel's launch plan: how many blocks each
64-key tile is split into over the GQA group's query heads (at every
tensor-core head_dim, 32 to 256), the grid, the launches a call and the
f32 workspace of the split.  The plan
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


def _grid(b, t, kv, hd=None):
    """Blocks of the unsplit tensor-core dkv kernel: one per key tile of 64
    keys, KV head and batch row, at every head_dim from 32 to 256."""
    return -(-t // 64) * kv * b


# (path, B, T, KV, group, head_dim, split): every shape a main path gives
# the bf16 dkv kernel (PERF.md's row 3), and the split its planner picks
PATH_PLANS = [
    # a batch row or two at 8 or 4 KV heads: 128 blocks, under one wave;
    # a split of 2 makes 256, still under two waves (264), so 4
    ("pipeline microbatch, B=1 32/8 heads of 64", 1, 1024, 8, 4, 64, 4),
    ("a process a stage, B=1 32/8 of 64", 1, 1024, 8, 4, 64, 4),
    ("a TP rank's shard, B=2 16/4 of 64", 2, 1024, 4, 4, 64, 4),
    # group 1 has nothing to split; the 64-key tiles make 256 blocks
    ("moe dist rank, B=2 8/8 of 128", 2, 1024, 8, 1, 128, 1),
    # training at batch 4 fills the card unsplit
    ("llama training, B=4 32/8 of 64", 4, 1024, 8, 4, 64, 1),
    ("encdec training, B=4 16/16 of 64", 4, 1024, 16, 1, 64, 1),
    ("moonshot training, B=4 16/16 of 128", 4, 1024, 16, 1, 128, 1),
    ("vlm training, B=4 S=1280 48/8 of 128", 4, 1280, 8, 6, 128, 1),
    ("train_llm demo-100m, B=8 S=256 10/5 of 64", 8, 256, 5, 2, 64, 1),
    ("ragged llama, B=4 S=300 32/8 of 64", 4, 300, 8, 4, 64, 1),
    ("hd 32 window, B=1 S=256 4/4", 1, 256, 4, 1, 32, 1),
    ("hd 32 GQA, B=1 S=512 8/2", 1, 512, 2, 4, 32, 4),
]


@pytest.mark.parametrize("name,b,t,kv,group,hd,split", PATH_PLANS,
                         ids=[p[0] for p in PATH_PLANS])
def test_path_shapes_plan(name, b, t, kv, group, hd, split):
    """The bf16 tensor-core dkv kernel's plan at each main path's shape:
    its split, blocks, launches and workspace bytes."""
    assert fa_ops.dkv_split(b, t, kv, group, hd, H100_SMS) == split
    blocks = _grid(b, t, kv)
    plan = fa_ops.dkv_plan(b, t, kv, group, hd, torch.bfloat16, H100_SMS)
    assert plan == dict(split=split, blocks=blocks * split, launches=1 + (split > 1),
                        workspace_bytes=0 if split == 1 else 2 * split * b * t * kv * hd * 4)
    if split > 1:  # under one wave unsplit, two waves (or the whole group) split
        assert blocks < H100_SMS and (blocks * split >= 2 * H100_SMS or split == group)


def test_workspace_of_the_pipeline_microbatch():
    """At the pipeline's microbatch (B=1, T=1024, 8 KV heads of 64) with
    SPLIT 4: 4 x 1024 x 8 x 64 f32 partials of dk and of dv, 16.78 MB."""
    plan = fa_ops.dkv_plan(1, 1024, 8, 4, 64, torch.bfloat16, H100_SMS)
    assert plan["workspace_bytes"] == 4 * 1 * 1024 * 8 * 64 * 2 * 4 == 16_777_216
    assert plan["blocks"] == 512


@pytest.mark.parametrize("hd,dtype", [(16, torch.bfloat16), (16, torch.float32),
                                      (32, torch.float32), (64, torch.float32),
                                      (128, torch.float32)])
@pytest.mark.parametrize("b,t,kv,group", [(1, 300, 1, 16), (1, 4096, 1, 16), (1, 128, 2, 4),
                                          (4, 1024, 8, 4), (2, 37, 1, 2)])
def test_fma_instances_are_never_split(hd, dtype, b, t, kv, group):
    """hd 16 in bf16 and every f32 instance run the f32-FMA dkv kernel
    (32-key blocks, every head of the group in one block): no split."""
    if hd == 16:
        assert fa_ops.dkv_split(b, t, kv, group, hd, H100_SMS) == 1
    plan = fa_ops.dkv_plan(b, t, kv, group, hd, dtype, H100_SMS)
    assert plan == dict(split=1, blocks=-(-t // 32) * kv * b, launches=1, workspace_bytes=0)


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
    blocks = _grid(b, t, kv)
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
    for b, t, kv, group, sms, hd in itertools.product(
            (1, 2, 4), (1, 77, 128, 300, 1024, 4096), (1, 2, 8), (1, 2, 3, 4, 6, 16),
            (1, 66, 132), (32, 64, 128, 256)):
        split = fa_ops.dkv_split(b, t, kv, group, hd, sms)
        assert 1 <= split <= group and group % split == 0
        blocks = _grid(b, t, kv)
        assert split == 1 if blocks >= sms else (blocks * split >= 2 * sms or split == group)


def test_f32_instances_are_not_split():
    """The f32-FMA dkv kernel (32-key blocks, every head of the group in one
    block) takes no split, at head_dim 256 too."""
    plan = fa_ops.dkv_plan(1, 512, 1, 16, 256, torch.float32, H100_SMS)
    assert plan == dict(split=1, blocks=16, launches=1, workspace_bytes=0)
    plan = fa_ops.dkv_plan(2, 128, 1, 4, 16, torch.bfloat16, H100_SMS)
    assert plan == dict(split=1, blocks=8, launches=1, workspace_bytes=0)
