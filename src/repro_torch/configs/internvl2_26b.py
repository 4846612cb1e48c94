"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

Backbone only, per the assignment: the vision frontend is a STUB —
``input_specs()`` provides 256 precomputed patch embeddings (B, 256, d_model)
prepended to the text sequence; seq_len counts the combined sequence.
vocab 92553 padded to 92672 for TP-16 divisibility.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_vision_patches=256,
    rope_theta=1000000.0,
    sharding="tp+fsdp",
    source="arXiv:2404.16821",
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-26b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=250, n_vision_patches=8, sharding="tp", attn_chunk=32,
)
