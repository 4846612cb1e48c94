"""Plain PyTorch reference of the dense, MoE and vlm decoder stacks the
benchmark runs: float32 (TF32 off) with no kernels, cache or batching.

It imports nothing of the program (``repro_torch``) and takes nothing it made:
the weights are drawn again from the seed (``portbench.weights``), the inputs
are the benchmark's own.  It follows the configuration's ``run`` block:

* pre-norm blocks: RMSNorm (f32, eps), q/k/v projections, rotary embedding
  over every position (the first and second halves of a head rotated as a
  pair, frequencies theta^(-i/half)), causal attention with q head h reading
  KV head h // (n_heads / n_kv_heads), scale head_dim^-0.5, the output
  projection, then RMSNorm and a SwiGLU MLP (silu(x Wg) * (x Wi) Wo) or the
  mixture of experts;
* the mixture of experts: softmax router in f32, top-k, the chosen gates
  renormalised, each sequence a routing group in which an expert keeps the
  first ceil(top_k * S * capacity_factor / n_experts) tokens that chose it
  (later ones pass through), and the Switch load-balancing loss
  n_experts * sum_e mean(chose e) * mean(gate e) over the batch;
* vlm: the patch embeddings run in front of the text; the loss scores index
  j of the text at the position before text token j;
* loss: mean cross-entropy over the targets >= 0 (padded vocabulary
  masked), plus z_coef * mean lse^2 and aux_coef * the layers' summed aux;
* AdamW with an f32 master copy, global-norm clipping and the warmup-cosine
  learning rate of the optimizer's step count before the update.

``prec="fp8"`` is the control: the reference computed in the precision
below the configuration's bf16, as the program computes in bf16.  Every
tensor the program keeps in its served type is rounded to float8 e4m3 (one
scale a tensor) where the program rounds it to bf16: the weights where they
are used, the embedded inputs, each norm's, projection's, rotary's and
attention's output, the MLP's hidden product, the residual stream after
each addition and the logits, and in the backward the gradient at each of
those points; products accumulate in f32, and the softmax statistics, the
router's gates and the loss stay f32, as in the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

__all__ = ["mm", "rnd", "train_steps", "prefill_last_logits", "leaf_names", "is_expert_stack"]

_FP8_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Q8(torch.autograd.Function):
    """A tensor stored in fp8: rounded in the forward, and the gradient that
    flows back through it rounded too, as a program in fp8 stores both."""

    @staticmethod
    def forward(ctx, x):
        return _q8(x)

    @staticmethod
    def backward(ctx, g):
        return _q8(g)


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` stored in the precision: as it is in f32, rounded in fp8."""
    return _Q8.apply(x) if prec == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str, keep: bool = True) -> torch.Tensor:
    """A product of two stored operands, accumulated in f32; ``keep`` stores
    the output too."""
    out = rnd(a, prec) @ rnd(b, prec)
    return rnd(out, prec) if keep else out


def _rms(x, w, eps, prec="f32"):
    return rnd(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * rnd(w, prec), prec)


def _rope(x, theta):
    """x (B, N, H, hd) rotated at positions 0..N-1."""
    n, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(run, q, k, v, prec):
    """Causal attention: q (B, N, H, hd), k/v (B, N, KV, hd) -> (B, N, H*hd)."""
    b, n, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    scores = mm(q, k.transpose(-1, -2), prec, keep=False) * hd ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(probs, v, prec)
    return out.transpose(1, 2).reshape(b, n, h * hd)


def _moe(run, p, x, prec):
    """Mixture of experts on x (B, S, D), each row a routing group: (y, aux)."""
    moe = run["moe"]
    b, s, d = x.shape
    e, k = moe["n_experts"], moe["top_k"]
    cap = min(max(math.ceil(k * s * moe["capacity_factor"] / e), 1), s)
    gates = torch.softmax(mm(x, p["moe.router"], prec, keep=False), dim=-1)
    top_v, top_i = torch.topk(gates, k, dim=-1)
    top_v = top_v / top_v.sum(-1, keepdim=True).clamp_min(1e-9)
    chose = torch.zeros_like(gates).scatter(-1, top_i, 1.0)
    weight = torch.zeros_like(gates).scatter(-1, top_i, top_v)
    pos = torch.cumsum(chose, dim=1) - 1
    keep = (chose > 0) & (pos < cap)
    xf, wf, kf = x.reshape(b * s, d), weight.reshape(b * s, e), keep.reshape(b * s, e)
    y = torch.zeros_like(xf)
    for j in range(e):
        rows = kf[:, j].nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        xe = xf[rows]
        hidden = rnd(F.silu(mm(xe, p["moe.wg"][j], prec)) * mm(xe, p["moe.wi"][j], prec), prec)
        y = y.index_add(0, rows, rnd(mm(hidden, p["moe.wo"][j], prec) * wf[rows, j:j + 1], prec))
    aux = e * torch.sum(chose.mean(dim=(0, 1)) * gates.mean(dim=(0, 1)))
    return rnd(y, prec).reshape(b, s, d), aux


def _layer(run, p, h, prec):
    """One pre-norm block on h (B, N, D): (h, aux)."""
    b, n, _ = h.shape
    hd, eps = run["head_dim"], run["norm_eps"]
    x = _rms(h, p["ln"], eps, prec)
    q = mm(x, p["wq"], prec).reshape(b, n, run["n_heads"], hd)
    k = mm(x, p["wk"], prec).reshape(b, n, run["n_kv_heads"], hd)
    v = mm(x, p["wv"], prec).reshape(b, n, run["n_kv_heads"], hd)
    q, k = rnd(_rope(q, run["rope_theta"]), prec), rnd(_rope(k, run["rope_theta"]), prec)
    h = rnd(h + mm(_attention(run, q, k, v, prec), p["wo"], prec), prec)
    x = _rms(h, p["ln2"], eps, prec)
    if run.get("moe"):
        y, aux = _moe(run, p, x, prec)
        return rnd(h + y, prec), aux
    hidden = rnd(F.silu(mm(x, p["mlp.wg"], prec)) * mm(x, p["mlp.wi"], prec), prec)
    return rnd(h + mm(hidden, p["mlp.wo"], prec), prec), torch.zeros((), device=h.device)


def is_expert_stack(name: str) -> bool:
    """An expert weight stack (``moe.wi|wg|wo``): its gradient moves with
    every route that rounding flips."""
    return ".moe.w" in name or name.startswith("moe.w")


def leaf_names(weights) -> list[str]:
    """``name`` of a global weight, ``layers.<l>.<name>`` of a layer's."""
    return [n if l is None else f"layers.{l}.{n}" for n, l in weights.names()]


def _loss(run, spec, w, batch, prec):
    h = rnd(w["embed"], prec)[batch["tokens"].long()]
    n_prefix = run.get("n_vision_patches", 0)
    if n_prefix:
        h = torch.cat([rnd(batch["patch_embeds"].float(), prec), h], dim=1)
    aux = torch.zeros((), device=h.device)
    for layer in range(len(w["layers"])):
        def block(x, p=w["layers"][layer]):
            return _layer(run, p, x, prec)
        h, a = checkpoint.checkpoint(block, h, use_reentrant=False)
        aux = aux + a
    s = batch["tokens"].shape[1]
    if n_prefix:
        h = h[:, n_prefix - 1:n_prefix - 1 + s]
    h = _rms(h, w["final_norm"], run["norm_eps"], prec)
    logits = mm(h, w["lm_head"], prec)
    vocab = run["vocab_size"]
    if logits.shape[-1] != vocab:
        cols = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = logits.masked_fill(cols, -1e30)
    targets = batch["targets"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    valid = (targets >= 0).float()
    n_valid = valid.sum().clamp_min(1.0)
    ce = ((lse - gold) * valid).sum() / n_valid
    z = spec["loss"]["z_coef"] * (lse.square() * valid).sum() / n_valid
    return ce + z + spec["loss"]["aux_coef"] * aux


def _lr(sched: dict, step: int) -> float:
    """warmup_cosine of the optimizer's step count before the update."""
    peak, warm, total = sched["peak_lr"], sched["warmup_steps"], sched["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    frac = sched["final_frac"]
    return peak * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(run: dict, spec: dict, weights, batches: list[dict], prec: str = "f32",
                half_batch: bool = False, keep_grad: bool = False) -> dict:
    """Train ``len(batches)`` AdamW steps from the seeded weights.  Returns
    each step's loss, each leaf's gradient norm at the first step (before
    clipping) and each leaf's change after the last step, by ``leaf_names``;
    with ``keep_grad`` also the first gradient itself on the host, every
    leaf but the expert stacks (``grad_full``).  ``half_batch`` is a fault for the control test:
    each step's loss is the mean over the first half of the batch alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = weights.device
    names = leaf_names(weights)
    flat = [weights.get(n, l, torch.float32).requires_grad_(True) for n, l in weights.names()]
    n_glob = len(weights.glob)
    per = list(weights.per_layer)

    def tree():
        w = {n: flat[i] for i, n in enumerate(weights.glob)}
        w["layers"] = [{n: flat[n_glob + layer * len(per) + j] for j, n in enumerate(per)}
                       for layer in range(weights.n_layers)]
        return w

    opt = spec["optimizer"]
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    out = {"loss": [], "grad": None}
    for t, batch in enumerate(batches):
        b = {k: torch.as_tensor(x, device=dev) for k, x in batch.items()}
        if half_batch:
            b = {k: x[: x.shape[0] // 2] for k, x in b.items()}
        loss = _loss(run, spec, tree(), b, prec)
        grads = torch.autograd.grad(loss, flat)
        out["loss"].append(float(loss.detach()))
        norms = torch.stack([g.square().sum() for g in grads])
        if t == 0:
            out["grad"] = dict(zip(names, norms.sqrt().tolist()))
            if keep_grad:
                out["grad_full"] = {n: g.detach().cpu() for n, g in zip(names, grads)
                                    if not is_expert_stack(n)}
        gnorm = float(norms.sum().sqrt())
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-12))
        lr = _lr(spec["schedule"], t)
        c1, c2 = 1 - opt["b1"] ** (t + 1), 1 - opt["b2"] ** (t + 1)
        with torch.no_grad():
            for x, g, mi, vi in zip(flat, grads, m, v):
                g = g * scale
                mi.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                vi.mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                upd = (mi / c1) / (torch.sqrt(vi / c2) + opt["eps"]) + opt["weight_decay"] * x
                x.sub_(lr * upd)
        del grads, loss
    with torch.no_grad():
        out["delta"] = {name: float((x - weights.get(n, l, torch.float32)).norm())
                        for name, x, (n, l) in zip(names, flat, weights.names())}
    return out


@torch.no_grad()
def prefill_last_logits(run: dict, weights, prompts: list[list[int]],
                        prec: str = "f32") -> list[torch.Tensor]:
    """The last position's logits (f32, the true vocabulary) of each prompt
    behind a zero patch prefix (vlm), computed layer by layer: each layer's
    weights are drawn once and every prompt passes through it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = weights.device
    n_prefix = run.get("n_vision_patches", 0)
    embed = rnd(weights.get("embed", None, torch.float32), prec)
    hs = []
    for prompt in prompts:
        h = embed[torch.as_tensor(prompt, device=dev).long()][None]
        if n_prefix:
            h = torch.cat([torch.zeros(1, n_prefix, run["d_model"], device=dev), h], dim=1)
        hs.append(h)
    del embed
    for layer in range(weights.n_layers):
        p = {n: weights.get(n, layer, torch.float32) for n in weights.per_layer}
        hs = [_layer(run, p, h, prec)[0] for h in hs]
        del p
    norm = weights.get("final_norm", None, torch.float32)
    head = weights.get("lm_head", None, torch.float32)
    return [mm(_rms(h[0, -1], norm, run["norm_eps"], prec), head, prec)[: run["vocab_size"]]
            for h in hs]
