"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
Small llama3 (tied embeddings).  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tied_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, attn_chunk=32,
)
