"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (kimi/moonlight).  [hf:moonshotai/Moonlight-16B-A3B; hf]

``d_ff`` is the per-expert FFN width (1408); experts are sharded over the
``model`` mesh axis (expert parallelism, 64/16 = 4 experts per shard).
"""

from ..models.config import ArchConfig, MoESettings

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    rope_theta=50000.0,
    moe=MoESettings(n_experts=64, top_k=6, d_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="moonshot-v1-16b-a3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=96, vocab_size=256, head_dim=16,
    moe=MoESettings(n_experts=8, top_k=2, d_expert=96), attn_chunk=32,
)
