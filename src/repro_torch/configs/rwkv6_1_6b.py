"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay WKV recurrence.  [arXiv:2404.05892; unverified]

``long_500k`` runs for this arch: decode state is O(H·K·V) per layer,
independent of context length.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,       # informational; WKV heads come from rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    source="arXiv:2404.05892",
)

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6-1.6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, rwkv_head_dim=16, attn_chunk=32,
)
