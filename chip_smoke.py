#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold the flash-attention kernel against its plain PyTorch version on the
   card (serving shape B=1, H=32, KV=8, hd=64, S=T=512 causal bf16; ragged
   S=T=300; window 128; f32) and time kernel, plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it);
3. the same for the RMSNorm kernel at (512, 2048), (300, 2048), (4, 2048)
   and (512*32, 64) bf16, with ``F.rms_norm`` as the yardstick;
4. serve full-width llama3.2-1b (16 layers, d_model 2048, 32/8 heads,
   vocab 128256, tied; seeded random bf16 weights) through
   ``repro_torch.launch.serve.run_serving`` with both kernels selected:
   8 requests with prompts of 512 and 300 tokens, 16 new tokens each,
   4 slots.  The launch counters are set to 0 just before and read just
   after; they must equal 16 x prefills (flash) and 2 x 16 x (prefills +
   decode steps) (RMSNorm).  Each prompt's prefill logits, and one decode
   step, are held against the same model on the plain path
   (``attn_impl="chunked"``, ``norm_impl="ref"``) on the card;
5. profile a warm window of the same engine (4 more requests) with
   ``torch.profiler``: device busy share and the top kernels by device time.

Kernel times are medians over CUDA events of back-to-back launches queued
behind a device-side sleep (so host overhead is not in them), with inputs
resident in L2.  Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s, 989
TFLOP/s for bf16 tensor-core work, 67 TFLOP/s for f32 CUDA-core work.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}

# full-width serving run (configs/llama3_2_1b.py)
N_REQUESTS, PROMPT_LENS, MAX_NEW, N_SLOTS, SEED = 8, (512, 300), 16, 4, 0
# bf16 model tolerance of the repo (tests/test_model_pallas_path.py)
MODEL_ATOL, MODEL_RTOL = 0.1, 0.05
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def _print(*args) -> None:
    print(*args, flush=True)


def _device_ms(torch, fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back calls
    queued behind a device sleep, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms: the host queues every call first
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def _bound_ms(n_bytes: float, flops: float, peak: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _flash_phase(torch, F, fa_ops, gen):
    cases = [  # (name, S=T, window, dtype)
        ("path S=T=512 causal bf16", 512, None, torch.bfloat16),
        ("ragged S=T=300 causal bf16", 300, None, torch.bfloat16),
        ("window=128 S=T=512 bf16", 512, 128, torch.bfloat16),
        ("f32 S=T=512 causal", 512, None, torch.float32),
    ]
    b, h, kv, hd = 1, 32, 8, 64
    rows = []
    for name, s, window, dtype in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dtype)
        out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, causal=True, window=window)
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        err = (out.float() - ref_out.float()).abs().max().item()

        pos = torch.arange(s, device="cuda")
        ok = pos[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[None, :] > pos[:, None] - window
        pairs = int(ok.sum())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None if window is None else ok
        ms = _device_ms(torch, lambda: fa_ops.flash_fwd(q, k, v, causal=True, window=window))
        plain_ms = _device_ms(
            torch, lambda: fa_ops.flash_fwd_plain(q, k, v, causal=True, window=window))
        library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True))
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, lse))
        flops = 4.0 * b * h * pairs * hd
        bound_ms, bound_by = _bound_ms(
            n_bytes, flops, "bf16_tensor" if dtype == torch.bfloat16 else "f32")
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        _print(f"[flash] {name}: max_abs_err={err:.3e} lse_err="
               f"{(lse - ref_lse).abs().max().item():.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}) "
               f"library_ms={library_ms:.5f}")
    return rows


def _rmsnorm_phase(torch, F, rn_ops, gen):
    cases = [(512, 2048), (300, 2048), (N_SLOTS, 2048), (512 * 32, 64)]
    rows = []
    for n, d in cases:
        x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(torch.bfloat16)
        y = rn_ops.rms_norm_fused(x, w, 1e-5)
        torch.cuda.synchronize()
        ref = rn_ops.rms_norm_plain(x, w, 1e-5)
        tol = KERNEL_TOL["bfloat16"]
        torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
        err = (y.float() - ref.float()).abs().max().item()
        ms = _device_ms(torch, lambda: rn_ops.rms_norm_fused(x, w, 1e-5))
        plain_ms = _device_ms(torch, lambda: rn_ops.rms_norm_plain(x, w, 1e-5))
        library_ms = _device_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5))
        n_bytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        bound_ms, bound_by = _bound_ms(n_bytes, 4.0 * n * d, "f32")
        rows.append(dict(case=f"({n}, {d}) bf16", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        _print(f"[rmsnorm] ({n}, {d}) bf16: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}) "
               f"library_ms={library_ms:.5f}")
    return rows


def _scope(sess, name):
    for root in sess.tree():
        for _, node in root.walk():
            if node.name == name:
                return node.count, node.inclusive
    raise KeyError(name)


def _serve_phase(torch, fa_ops, rn_ops):
    import numpy as np

    from repro_torch.launch.serve import make_requests, run_serving
    from repro_torch.models import model as M
    from repro_torch.timing import TimingSession

    sess = TimingSession()
    fa_ops.launches = 0
    rn_ops.launches = 0
    t0 = time.perf_counter()
    with sess:
        engine = run_serving(
            "llama3.2-1b", N_REQUESTS, PROMPT_LENS, MAX_NEW,
            n_slots=N_SLOTS, seed=SEED, session=sess, smoke=False,
            attn_impl="pallas", norm_impl="fused", dtype="bfloat16", device="cuda",
        )
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa_ops.launches, "rmsnorm_fwd": rn_ops.launches}

    cfg = engine.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (
        16, 2048, 32, 8, 128256), cfg
    n_prefill, prefill_s = _scope(sess, "serve/prefill")
    n_decode, decode_s = _scope(sess, "serve/decode")
    stats = engine.stats()
    results = sorted(engine.completed, key=lambda r: r.rid)
    assert len(results) == N_REQUESTS and stats["shed"] == 0.0, stats
    assert all(r.status == "completed" and len(r.tokens) == MAX_NEW for r in results)
    assert n_prefill == N_REQUESTS, n_prefill
    assert launches["flash_fwd"] == cfg.n_layers * n_prefill, (launches, n_prefill)
    assert launches["rmsnorm_fwd"] == 2 * cfg.n_layers * (n_prefill + n_decode), (
        launches, n_prefill, n_decode)
    _print(f"[serve] {N_REQUESTS} requests, prompts {PROMPT_LENS}, max_new {MAX_NEW}, "
           f"{N_SLOTS} slots: wall_s={wall:.3f} prefills={n_prefill} decode_steps={n_decode} "
           f"launches={launches}")
    _print(f"[serve] tokens_per_s={stats['throughput_tokens_per_s']:.3f} "
           f"p95_ttft_s={stats['p95_ttft_s']:.5f} p95_latency_s={stats['p95_latency_s']:.5f} "
           f"timer serve/prefill_s={prefill_s:.5f} serve/decode_s={decode_s:.5f}")

    # the served model against itself on the plain path, on the card
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    requests = make_requests(cfg.vocab_size, N_REQUESTS, PROMPT_LENS, MAX_NEW,
                             np.random.default_rng(SEED))
    exact = 0
    worst = 0.0
    for req, res in zip(requests, results):
        tokens = torch.tensor([req.prompt], dtype=torch.int32, device="cuda")
        outs = []
        for c in (cfg, plain):
            cache = M.init_cache(c, 1, engine.max_seq, device="cuda")
            cache, logits = M.prefill(c, engine.params, {"tokens": tokens}, cache)
            outs.append((cache, logits[0, : c.vocab_size].float()))
        (cache_k, lk), (cache_p, lp) = outs
        assert lk.shape == (cfg.vocab_size,) and bool(torch.isfinite(lk).all())
        torch.testing.assert_close(lk, lp, atol=MODEL_ATOL, rtol=MODEL_RTOL)
        worst = max(worst, (lk - lp).abs().max().item())
        first = res.tokens[0]
        assert int(lk.argmax()) == first, (req.rid, int(lk.argmax()), first)
        if int(lp.argmax()) == first:
            exact += 1
        else:  # a near-tie on the plain path: the served token is within tolerance of its max
            assert lp[first] >= lp.max() - MODEL_ATOL, (req.rid, first, lp.max().item())
        if req.rid == 0:  # one decode step on each path
            step = torch.tensor([[first]], dtype=torch.int32, device="cuda")
            _, dk = M.decode_step(cfg, engine.params, cache_k, step)
            _, dp = M.decode_step(plain, engine.params, cache_p, step)
            torch.testing.assert_close(dk.float(), dp.float(), atol=MODEL_ATOL, rtol=MODEL_RTOL)
    _print(f"[serve] prefill logits vs plain path: max_abs_diff={worst:.4f} "
           f"(atol {MODEL_ATOL}, rtol {MODEL_RTOL}); first token equal on {exact}/{N_REQUESTS}")
    return launches, engine, sess


def _profile_phase(torch, engine, sess):
    """Where a warm serving window's time goes: the same engine serves
    N_SLOTS more requests under ``torch.profiler``; device busy share =
    summed kernel time over the window's wall time (the profiler's own host
    cost inflates the wall, so the idle share is an upper bound)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 1)
    requests = [
        Request(1000 + i, prompt=[int(t) for t in rng.integers(
            0, engine.cfg.vocab_size, PROMPT_LENS[i % len(PROMPT_LENS)])],
            max_new_tokens=MAX_NEW)
        for i in range(N_SLOTS)
    ]
    before = {name: _scope(sess, name) for name in ("serve/prefill", "serve/decode")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            engine.submit(req)
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    phases = {}
    for name, (count0, seconds0) in before.items():
        count, seconds = _scope(sess, name)
        phases[name] = f"{count - count0} x {1e3 * (seconds - seconds0) / max(count - count0, 1):.3f} ms"
    _print(f"[profile] warm window: {len(requests)} requests, wall_s={wall:.4f} "
           f"device_kernel_s={device_s:.4f} device_busy_share={device_s / wall:.4f}; {phases}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        _print(f"[profile]   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _print(smi)
    _print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _print(f"[build] kernels {', '.join(build.SOURCES)} built and loaded in "
           f"{build.build_all():.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = _flash_phase(torch, F, fa_ops, gen)
    rms = _rmsnorm_phase(torch, F, rn_ops, gen)
    launches, engine, sess = _serve_phase(torch, fa_ops, rn_ops)
    _profile_phase(torch, engine, sess)

    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=launches["flash_fwd"],
             **{k: flash[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}),
        dict(name="rmsnorm_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:30",
             launches=launches["rmsnorm_fwd"],
             **{k: rms[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}),
    ]}
    _print(json.dumps(record))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
