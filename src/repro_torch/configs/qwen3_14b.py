"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    use_qk_norm=True,
    sharding="tp+fsdp",
    source="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, sharding="tp", attn_chunk=32,
)
