"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

Backbone only, per the assignment: the speech frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
24 encoder layers + 24 decoder layers (speech encoder + text decoder).
vocab 256206 is padded to 256256 for TP-16 divisibility (loss masks the pad).
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    audio_frontend=True,
    rope_theta=10000.0,
    source="arXiv:2308.11596",
)

SMOKE_CONFIG = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke", n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=250, attn_chunk=32,
)
