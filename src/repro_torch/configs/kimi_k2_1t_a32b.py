"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8.  Trillion-parameter MoE (paper-table entry).
[arXiv:2501.kimi2; unverified]

Notes: head_dim pinned to 128 (64·128 ≠ d_model; q/o projections are
rectangular, standard for K2-class models).  ``d_ff`` is per-expert width.
Sharding: TP+FSDP+EP — at 1T parameters even the 512-chip multi-pod mesh
cannot hold AdamW train state (see EXPERIMENTS.md §Dry-run for honest
bytes-per-device numbers); the dry-run proves the sharding is coherent.
"""

from ..models.config import ArchConfig, MoESettings

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=128,
    rope_theta=50000.0,
    moe=MoESettings(n_experts=384, top_k=8, d_expert=2048),
    sharding="tp+fsdp",
    source="arXiv:2501.kimi2",
)

SMOKE_CONFIG = CONFIG.replace(
    name="kimi-k2-1t-a32b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab_size=256, head_dim=16, sharding="tp",
    moe=MoESettings(n_experts=8, top_k=2, d_expert=96), attn_chunk=32,
)
