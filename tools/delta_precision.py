#!/usr/bin/env python3
"""Where the bf16 flash backward's gradients part from f32, on the CPU:

    PYTHONPATH=src python3 tools/delta_precision.py [--layers 24] [--seq 1024]

seamless-m4t-large-v2 at full width (d_model 1024, 16/16 heads of 64, d_ff
8192) with ``--layers`` encoder and as many decoder layers, its vocabulary
cut to 4096 (the LM head is not what is measured), batch 1 x ``--seq``
tokens from as many seeded random source frames, bf16 weights from a seed.
One loss-and-gradient step runs on five paths:

* ``f32``: the plain path (``attn_impl="chunked"``, ``norm_impl="ref"``) in
  f32 on the same weights upcast, the anchor;
* ``plain``: the plain path in bf16 (autograd through the attention);
* ``kernels, f32 inside``: the kernel path (``attn_impl="pallas"``), whose
  wrappers run their plain versions on CPU tensors: the flash VJP's
  algorithm, ``delta = rowsum(dO * out)`` from the bf16 output as the
  reference's ``flash_attention`` VJP forms it, with every kernel's
  arithmetic in f32;
* ``kernels, tensor-core rounding``: the same with the bf16 tensor-core
  kernels' roundings emulated (P rounded to bf16 before P V in the forward;
  P and dS rounded before dV = P^T dO, dQ = dS K and dK = dS^T Q);
* ``kernels, delta from the f32 output``: the f32-inside kernel path with
  delta formed from the attention output in f32 instead.

Prints, for each path, each gradient leaf's relative L2 distance from the
``f32`` path.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named(value, f"{prefix}/{key}" if prefix else key)
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _named(value, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix


def tc_fwd(q, k, v, *, causal, window):
    """The forward with P rounded to bf16 before P V, in one pass: the
    kernel rounds each key tile's P against its running maximum, this
    rounds the normalised P (the same relative rounding, not the same
    bits)."""
    b, s, h, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    scores = torch.einsum("bskgd,btkd->bkgst", fa._grouped(q, n_kv), k.float()) * hd ** -0.5
    scores = scores.masked_fill(~fa._allowed(s, t, causal, window, q.device), float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", _bf16(p), v.float()).reshape(b, s, h, hd)
    return out.to(q.dtype), lse.reshape(b, h, s)


def tc_dq(q, k, v, do, lse, delta, *, causal, window):
    b, s, h, hd = q.shape
    _, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bkgst,btkd->bskgd", _bf16(ds), k.float()) * hd ** -0.5
    return dq.reshape(b, s, h, hd).to(q.dtype)


def tc_dkv(q, k, v, do, lse, delta, *, causal, window):
    p, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, window)
    n_kv, hd = k.shape[2], q.shape[3]
    dk = torch.einsum("bkgst,bskgd->btkd", _bf16(ds), fa._grouped(q, n_kv)) * hd ** -0.5
    dv = torch.einsum("bkgst,bskgd->btkd", _bf16(p), fa._grouped(do, n_kv))
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_f32_delta(q, k, v, out, lse, do, *, causal, window):
    out32, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal=causal, window=window)
    delta = fa._delta(out32, do)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cfg = get_config("seamless-m4t-large-v2").replace(
        n_layers=args.layers, n_enc_layers=args.layers, vocab_size=4096, dtype="bfloat16",
        remat="none", attn_impl="pallas", norm_impl="fused")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, args.seq, 1, mode="copy", seed=0),
                        arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    names = list(_named(params))

    def grads(c, p):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        it = iter(leaves)
        loss, _ = M.loss_fn(c, tree_map(lambda _: next(it), p), batch)
        return [g.float() for g in torch.autograd.grad(loss, leaves)]

    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    anchor = grads(plain.replace(dtype="float32"), tree_map(lambda x: x.float(), params))
    kept = {n: getattr(fa, n) for n in ("flash_fwd_plain", "flash_bwd_dq_plain",
                                        "flash_bwd_dkv_plain", "flash_bwd_plain")}
    paths = {"plain": grads(plain, params), "kernels, f32 inside": grads(cfg, params)}
    fa.flash_fwd_plain, fa.flash_bwd_dq_plain, fa.flash_bwd_dkv_plain = tc_fwd, tc_dq, tc_dkv
    paths["kernels, tensor-core rounding"] = grads(cfg, params)
    for name, fn in kept.items():
        setattr(fa, name, fn)
    fa.flash_bwd_plain = bwd_f32_delta
    paths["kernels, delta from the f32 output"] = grads(cfg, params)
    fa.flash_bwd_plain = kept["flash_bwd_plain"]

    print(f"seamless-m4t-large-v2 width, {args.layers} + {args.layers} layers, vocab 4096, "
          f"batch 1 x {args.seq}, bf16; relative L2 distance of each gradient leaf from f32")
    for path, gs in paths.items():
        dist = {n: ((g - a).norm() / a.norm()).item() for n, g, a in zip(names, gs, anchor)}
        print(f"{path}: " + ", ".join(f"{n}={d:.3e}" for n, d in dist.items()))


if __name__ == "__main__":
    main()
