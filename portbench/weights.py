"""Weights drawn from ``--seed``, named by the benchmark, not by the program.

Every weight of a configuration has a name (``embed``, ``lm_head``,
``final_norm``, and per layer ``ln``, ``wq``, ``wk``, ``wv``, ``wo``,
``ln2`` and ``mlp.wi|wg|wo`` or ``moe.router|wi|wg|wo``) and is drawn on its
own: a ``torch.Generator`` on the weight's device, seeded from (seed, name,
layer), fills it with standard normals in f32 in one call, which are scaled
(1/sqrt(fan-in), 0.02 for the embedding; norm weights 1 + 0.1 N(0, 1), so
that a norm's weight is exercised) and cast to the type they are served in.
So any weight of any layer is drawn again alone, exactly: the program gets
them once at set-up, and the reference draws them again after the window,
layer by layer.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

__all__ = ["Layout", "layout", "Weights", "seed_of"]


@dataclass(frozen=True)
class Layout:
    shape: tuple[int, ...]
    init: str  # "normal" | "norm"
    scale: float
    dtype: torch.dtype


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def padded_vocab(run: dict) -> int:
    pad = run["vocab_pad_to"]
    return (run["vocab_size"] + pad - 1) // pad * pad


def layout(run: dict) -> tuple[dict[str, Layout], dict[str, Layout]]:
    """(global weights, per-layer weights) of a configuration's ``run`` block."""
    dt = _dtype(run["dtype"])
    d, hd = run["d_model"], run["head_dim"]
    q, kv = run["n_heads"] * hd, run["n_kv_heads"] * hd
    vp = padded_vocab(run)

    def normal(*shape, dtype=dt, scale=None):
        return Layout(tuple(shape), "normal", scale if scale is not None else shape[-2] ** -0.5,
                      dtype)

    glob = {
        "embed": normal(vp, d, scale=0.02),
        "lm_head": normal(d, vp),
        "final_norm": Layout((d,), "norm", 0.1, dt),
    }
    per_layer = {
        "ln": Layout((d,), "norm", 0.1, dt),
        "wq": normal(d, q),
        "wk": normal(d, kv),
        "wv": normal(d, kv),
        "wo": normal(q, d),
        "ln2": Layout((d,), "norm", 0.1, dt),
    }
    moe = run.get("moe")
    if moe:
        e, de = moe["n_experts"], moe["d_expert"]
        per_layer.update({
            "moe.router": normal(d, e, dtype=torch.float32),
            "moe.wi": normal(e, d, de),
            "moe.wg": normal(e, d, de),
            "moe.wo": normal(e, de, d),
        })
    else:
        f = run["d_ff"]
        per_layer.update({"mlp.wi": normal(d, f), "mlp.wg": normal(d, f),
                          "mlp.wo": normal(f, d)})
    return glob, per_layer


def seed_of(seed: int, name: str, layer: int | None) -> int:
    """A 63-bit generator seed for one weight of one layer."""
    digest = hashlib.sha256(f"portbench/{int(seed)}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class Weights:
    """The seeded weights of one configuration at ``n_layers`` layers."""

    def __init__(self, run: dict, seed: int, n_layers: int, device) -> None:
        self.run = run
        self.seed = int(seed)
        self.n_layers = int(n_layers)
        self.device = torch.device(device)
        self.glob, self.per_layer = layout(run)

    def names(self) -> list[tuple[str, int | None]]:
        """Every (name, layer) in a fixed order: the globals, then layer by layer."""
        out: list[tuple[str, int | None]] = [(n, None) for n in self.glob]
        for layer in range(self.n_layers):
            out.extend((n, layer) for n in self.per_layer)
        return out

    def spec(self, name: str, layer: int | None) -> Layout:
        return self.glob[name] if layer is None else self.per_layer[name]

    def get(self, name: str, layer: int | None = None, dtype: torch.dtype | None = None):
        """The weight ``name`` of ``layer`` (None for a global), in its served
        type, or cast from it to ``dtype``."""
        spec = self.spec(name, layer)
        gen = torch.Generator(device=self.device).manual_seed(seed_of(self.seed, name, layer))
        x = torch.randn(spec.shape, generator=gen, device=self.device, dtype=torch.float32)
        if spec.init == "norm":
            x.mul_(spec.scale).add_(1.0)
        else:
            x.mul_(spec.scale)
        x = x.to(spec.dtype)
        return x if dtype is None else x.to(dtype)
