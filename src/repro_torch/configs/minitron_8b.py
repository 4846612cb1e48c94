"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Pruned nemotron.  [arXiv:2407.14679; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10000.0,
    sharding="tp+fsdp",
    source="arXiv:2407.14679",
)

SMOKE_CONFIG = CONFIG.replace(
    name="minitron-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, sharding="tp", attn_chunk=32,
)
