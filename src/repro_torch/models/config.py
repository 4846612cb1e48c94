"""Architecture and input-shape configuration.

Each assigned architecture gets a ``src/repro/configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) and ``SMOKE_CONFIG`` (a reduced config of
the same family for CPU tests).  ``ShapeConfig`` encodes the assigned input
shapes; ``train_*`` shapes lower ``train_step``, ``prefill_*`` lower the prefill
step, and ``decode_*``/``long_*`` lower ``serve_step`` (one new token against a
KV cache of ``seq_len``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["MoESettings", "ArchConfig", "ShapeConfig", "SHAPES"]


@dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_expert: int
    #: capacity factor for dropping-style dispatch (GShard); tokens above
    #: capacity are dropped to keep dispatch tensors static.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    rope_theta: float = 500000.0
    use_qk_norm: bool = False
    tied_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: MoESettings | None = None
    #: layer-type cycle; dense = ("attn",), hybrid e.g. ("rglru","attn_local","attn_local")
    block_pattern: tuple[str, ...] = ("attn",)
    #: sliding window for attn_local blocks
    window: int | None = None
    #: encoder layers (enc-dec archs; n_layers is then the decoder depth)
    n_enc_layers: int = 0
    #: [vlm]: number of stub patch embeddings prepended to the text sequence
    n_vision_patches: int = 0
    #: [audio]: source sequence is precomputed frame embeddings (stub frontend)
    audio_frontend: bool = False
    #: rwkv6 head size (state is head_dim x head_dim per head)
    rwkv_head_dim: int = 64
    #: conv width for RG-LRU blocks
    conv_width: int = 4
    rglru_c: float = 8.0
    dtype: str = "bfloat16"
    #: sharding preset: "tp" | "tp+fsdp" ; see dist/sharding.py
    sharding: str = "tp"
    #: remat policy for the layer scan: "none" | "dots" | "full"
    remat: str = "dots"
    #: attention implementation: "naive" | "chunked" (default) | "pallas"
    attn_impl: str = "chunked"
    attn_chunk: int = 512
    #: rmsnorm implementation: "ref" (unfused, default) | "fused" (Pallas
    #: kernel; interpret-mode on CPU via default_interpret)
    norm_impl: str = "ref"
    #: pad vocab up to a multiple of this for sharding (logits masked to true vocab)
    vocab_pad_to: int = 256
    #: §Perf knobs (EXPERIMENTS.md): pre-reshard embedding/lm_head before the
    #: token gather (fixes FSDP involuntary remat)
    embed_gather_constraint: bool = False
    #: MoE dispatch activation constraints: "embed" (baseline; constrains the
    #: hidden dim, conflicts with FSDP) | "tokens" (batch+expert only)
    moe_dispatch_mode: str = "embed"
    #: chunked cross-entropy: compute logits+CE in seq chunks of this size
    loss_chunk: int = 0
    #: source/published reference for the config
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        pad = self.vocab_pad_to
        return ((self.vocab_size + pad - 1) // pad) * pad

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        """Expanded per-layer block kinds of length n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def n_params(self, active_only: bool = False) -> int:
        """Approximate parameter count (used for 6·N·D model-FLOPs)."""
        d, hd = self.d_model, self.resolved_head_dim
        per_layer = 0
        kinds = self.layer_kinds()
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        for kind in kinds:
            if kind in ("attn", "attn_local"):
                per_layer += attn
            elif kind == "rglru":
                # in/out projections + gates (diagonal recurrence)
                per_layer += 2 * d * d + 2 * d * d // 1 + 3 * d
            elif kind == "rwkv":
                h = self.rwkv_n_heads
                per_layer += 4 * d * d + d * self.rwkv_head_dim  # r,k,v,o + decay lora (approx)
            if self.moe is not None and kind != "rwkv":
                experts = self.moe.top_k if active_only else self.moe.n_experts
                per_layer += experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
            elif kind == "rwkv":
                per_layer += 2 * d * self.d_ff + d * d  # channel mix (k,v,r)
            else:
                per_layer += 3 * d * self.d_ff  # gated mlp
        total = per_layer * self.n_layers
        # encoder stack (same block shape, attn + mlp)
        total += self.n_enc_layers * (attn + 3 * d * self.d_ff)
        total += self.padded_vocab * d * (1 if self.tied_embeddings else 2)
        return total

    def replace(self, **kwargs) -> ArchConfig:
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a shape cell runs for an arch (DESIGN.md §4 records the skips)."""
    if shape.name == "long_500k":
        kinds = set(cfg.layer_kinds())
        sub_quadratic = kinds <= {"rglru", "attn_local", "rwkv"} and (
            "rglru" in kinds or "rwkv" in kinds
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k decode is not sub-quadratic"
    return True, ""
