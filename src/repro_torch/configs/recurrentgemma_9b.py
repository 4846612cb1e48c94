"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 1 recurrent : 2 local-attn
pattern per the assignment, window 2048.  [arXiv:2402.19427; unverified]

``long_500k`` runs for this arch: the RG-LRU state is O(d) and the local
attention cache is a 2048-slot ring buffer, so the 524,288-token decode cell is
sub-quadratic.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    block_pattern=("rglru", "attn_local", "attn_local"),
    window=2048,
    sharding="tp+fsdp",
    source="arXiv:2402.19427",
)

SMOKE_CONFIG = CONFIG.replace(
    name="recurrentgemma-9b-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16, window=16,
    sharding="tp", attn_chunk=32,
)
