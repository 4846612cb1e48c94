#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, run in this order (any failure raises and exits non-zero; nothing is
caught):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold the flash-attention kernel against its plain PyTorch version on the
   card (serving shape B=1, H=32, KV=8, hd=64, S=T=512 causal bf16; ragged
   S=T=300; window 128; f32; the training shape B=4, S=T=1024 causal bf16)
   and time kernel, plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only; the port never calls it);
3. the same for the RMSNorm kernel at (512, 2048), (300, 2048), (4, 2048),
   (512*32, 64) and the training shape (4096, 2048) bf16, with
   ``F.rms_norm`` as the yardstick;
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
   ``torch.profiler``: device busy share and the top kernels by device time;
6. hold the flash backward kernels (dq, and dk/dv summed over the GQA
   group), and the forward kernel that makes their inputs, against their
   plain versions at the training shape B=4,
   S=T=1024, H=32, KV=8, hd=64 causal bf16, ragged S=T=300, window 128 and
   f32, and time them beside the plain versions and the backward of
   ``F.scaled_dot_product_attention`` (a yardstick only);
7. the same for the RMSNorm backward kernel at (4096, 2048), (300, 2048),
   (16384, 64) bf16 and (7, 100) f32, with ``F.rms_norm``'s backward as the
   yardstick;
8. train full-width llama3.2-1b (bf16, remat "dots") through
   ``repro_torch.launch.train.run_training`` with both kernel pairs
   selected: global batch 4, seq 1024, 6 AdamW steps on the copy task.  The
   five launch counters are set to 0 just before and read just after; per
   step they must equal 2L flash forwards (the block forward runs again in
   the backward), L dq, L dkv, 4L RMSNorm forwards and 2L RMSNorm backwards
   (L = 16; the final norm is the unfused one).  Every loss must be finite.
   One loss-and-gradient step on the kernel path is held against the plain
   path (``attn_impl="chunked"``, ``norm_impl="ref"``) on the card from the
   same weights and batch: loss, gradient norm and each leaf's relative
   error; every leaf's gradient must be finite and nonzero;
9. profile one warm training step with ``torch.profiler``;
10. hold the RG-LRU kernel against its plain version at recurrentgemma-9b's
    prefill shape (1, 2560, 4096) f32 with h0, and at (1, 512, 4096),
    ragged (1, 300, 4096), (4, 1024, 4096) and bf16: y and the final state;
    time kernel and plain version (no single PyTorch call computes a linear
    recurrence, so there is no library yardstick);
11. the same for the WKV-6 kernel at rwkv6-1.6b's prefill shape
    (1, 512, 32, 64) with bf16 r/k/v, f32 w and a state, ragged S=300,
    (4, 1024, 32, 64) and all-f32;
12. serve full-width recurrentgemma-9b (38 layers, d_model 4096, 16/1 heads,
    hd 256, vocab 256000, window 2048; seeded random bf16 weights) with
    ``attn_impl="pallas"``, ``norm_impl="fused"``, ``seq_impl="pallas"``:
    8 requests with prompts of 2560 and 512 tokens (the 2048-slot ring wraps
    on the long ones), 16 new tokens each, 4 slots.  The launch counters,
    set to 0 just before, must equal 13 x prefills (RG-LRU), 25 x prefills
    (flash) and 76 x (prefills + decode steps) (RMSNorm), and 0 for WKV-6;
    each prompt's prefill logits and one decode step are held against the
    plain path (``attn_impl="chunked"``, ``norm_impl="ref"``,
    ``seq_impl="parallel"``) on the card, in relative L2 norm (50%, against
    gross failure: 38 random bf16 layers amplify the paths' rounding
    differences; the plain path's spread under ``seq_impl="ref"`` is
    printed beside it);
13. profile a warm window of that engine; then hold the same architecture
    in f32, cut to 4 layers (one unit and its tail), kernel path against
    plain path at the f32 model tolerance 2e-4, prompts of 2560 and 512;
14. serve full-width rwkv6-1.6b (24 layers, d_model 2048, head size 64,
    vocab 65536) the same way, prompts of 512 and 300 tokens: WKV-6
    24 x prefills, RMSNorm 72 x (prefills + decode steps) (ln1, the group
    norm and ln2), RG-LRU and flash 0; held against the plain path;
15. profile a warm window of that engine; then the same architecture in f32
    at full depth, kernel path against plain path at 2e-4;
16. head_dim 16, the smoke configs' (``_smoke_phase``): serve the
    llama3.2-1b and recurrentgemma-9b smoke configs (bf16) through
    ``attn_impl="pallas"``, ``norm_impl="fused"``, ``seq_impl="pallas"``,
    4 requests of 128-token prompts each, with exact launch counts and the
    prefill logits held against the plain path at the repo's bf16 model
    tolerance; train the llama3.2-1b smoke config 3 steps (bf16, batch
    2 x 128) with exact flash forward/dq/dkv launch counts; one
    loss-and-gradient step against the plain path in bf16 (as phase 8) and
    one in f32 (each leaf to 1e-3);
17. checkpoint and resume full-width llama3.2-1b (``_ckpt_phase``), under
    the temporary directory or, when that has under 25 GB free, the
    checkout's ``build/`` (the free space of each is printed): the bf16
    params from the seed go through ``CheckpointManager(keep_n=1)``
    (``save``, ``wait``, ``restore_latest(device="cuda")``) and every leaf
    must come back ``torch.equal``, bf16 kept (bytes, blocking, write,
    validate and load seconds printed); run A trains phase 8's first 3
    steps (``lr_total_steps=6``, ``ckpt_mode="fixed"``, ``ckpt_every``
    above 3, a metrics textfile and a status file) and saves the 17.30 GB
    training state at shutdown (label 3); run B (``steps=6``,
    ``ckpt_mode="off"``, ``restore=True``) restores it and trains steps
    4-6.  Each run's launch counts must equal phase 8's per-step counts x
    its 3 steps; run B's resume summary must show one valid checkpoint and
    none quarantined, and it writes nothing; both runs' losses are held
    against phase 8's at the same steps at TRAIN_RTOL (the largest
    difference and whether they are bitwise equal are printed); the
    textfile must parse under ``repro_torch.monitor.promparse`` with its
    ``io_bytes`` sample equal to the checkpoint's array bytes, and the
    status file must hold run A's last iteration and loss.

Phase 2 also holds the flash kernel at head_dim 256 (recurrentgemma-9b's MQA
heads, window 2048) at S=T=2560 and 512 bf16.  Phases 2 and 6 also hold the
flash kernels at head_dim 16, at phase 16's shapes (B=2, S=T=128; 4/2 heads
causal and 4/1 heads with window 16; bf16 and f32), elementwise at the
kernel tolerances.  Memory is freed between the
serving and the training phases and before phase 10.

Which design runs where: in bf16 at head_dim 32 to 256, ``flash_fwd``
(phases 2, 4, 8, 12), ``flash_bwd_dq`` and ``flash_bwd_dkv`` (phases 6, 8)
are tensor-core kernels (``wgmma`` fed by TMA through an mbarrier-guarded
shared-memory ring, sm_90a); their f32 instances (the f32 cases of phases 2
and 6, the f32 model of phase 13, the f32 gradient step of phase 16) and
their bf16 instances at head_dim 16 (phases 2, 6 and 16) are f32-FMA
kernels on the CUDA cores, as are the RMSNorm, RG-LRU and WKV-6 kernels.
Phases 2 and 6 print, for every case, the design (as the kernel library
reports it), registers a thread (and local spill bytes) and shared memory a
block of the instance that ran; phase 7 the
RMSNorm backward's registers, grid and launches per call (one, or two with
the column sum of dw).  RG-LRU is one chunked pass with a decoupled
look-back (one launch a call, after a memset of its look-back words), WKV-6
three chunked launches (chunk states, their carry, chunk outputs) counted as
one call; phases 10 and 11 assert one counted launch a call and print each
case's grid.

Kernel times are medians over 7 windows of 20 calls queued behind a
device-side sleep (so host overhead is not in them), each call timed by its
own pair of CUDA events with a 256 MB write queued before it, outside the
pair: no call finds its inputs in the 50 MB L2 from the call before.  The
plain versions and the library calls are timed the same way.  The
recurrences' plain versions are Python loops of small launches, so their
times are host-bound.  Bounds use the H100 SXM data-sheet peaks:
3.35 TB/s, 989 TFLOP/s for bf16 tensor-core work, 67 TFLOP/s for f32
CUDA-core work.  Every kernel line prints its share of its bound and, where
a library call computes the same function, its time over that call's; a
kernel time below its bound fails the run.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}

# full-width serving runs (configs/llama3_2_1b.py, recurrentgemma_9b.py, rwkv6_1_6b.py)
N_REQUESTS, PROMPT_LENS, MAX_NEW, N_SLOTS, SEED = 8, (512, 300), 16, 4, 0
HYBRID_PROMPT_LENS = (2560, 512)
# bf16 model tolerance of the repo (tests/test_model_pallas_path.py)
MODEL_ATOL, MODEL_RTOL = 0.1, 0.05
# the hybrid and SSM families, 38 and 24 random bf16 layers deep: the kernel
# and plain paths round differently (f32 against bf16 attention
# probabilities, the norms' and scans' summation orders), and random deep
# layers amplify rare bf16 rounding flips, so their bf16 logits are only
# held in relative L2 norm against gross failure (unrelated logits differ by
# ~1.41); the plain path's own spread under a second recurrence order
# (seq_impl="ref") is printed beside it.  The semantics are held in f32 at
# full width (the hybrid cut to one unit plus its tail) elementwise at the
# repo's f32 model tolerance (tests/test_torch_model.py)
RECURRENT_REL = 0.5
F32_ATOL = 2e-4
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# gradient tolerances of the repo (tests/test_kernels_flash.py:62,
# tests/test_kernel_dtype_drift.py): flash f32 5e-4; dw sums over rows
GRAD_TOL = {"bfloat16": 3e-2, "float32": 5e-4}
DW_TOL = {"bfloat16": 3e-2, "float32": 2e-4}

DEVICE = "cuda"
# full-width training run (configs/llama3_2_1b.py, remat "dots")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
# kernel path vs plain path on the card, bf16: loss and gradient norm to the
# bf16 gradient tolerance, each leaf's gradient to 10% in relative norm
TRAIN_RTOL, LEAF_RTOL = 3e-2, 0.1
# the smoke configs' phase (head_dim 16): prompt and sequence length, steps
SMOKE_SEQ, SMOKE_STEPS = 128, 3
# the checkpoint phase: run A trains steps 1-3 of phase 8's 6-step schedule
# and saves at shutdown (label 3); run B restores it and trains steps 4-6.
# The checkpoints need a local directory with this much room
CKPT_STEPS, CKPT_FREE_BYTES = 3, 25e9


def _print(*args) -> None:
    print(*args, flush=True)


# bytes written between timed calls: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def _device_ms(torch, fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` windows of ``inner`` calls queued behind a device
    sleep, per call.  Before each call a write of ``L2_FLUSH_BYTES`` evicts
    the L2, and each call is timed by its own pair of CUDA events, so no
    call finds its inputs in L2 from the call before and the flush is not
    in the time."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(inner)]
        torch.cuda._sleep(40_000_000)  # ~20 ms: the host queues every call first
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times.append(sum(start.elapsed_time(end) for start, end in events) / inner)
    del flush
    return sorted(times)[len(times) // 2]


def _bound_ms(n_bytes: float, flops: float, peak: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _shares(ms, bound_ms, library_ms=None) -> str:
    """A kernel's share of its bound, which no time can beat (the run fails
    if one does), and its time over the library call's where there is one."""
    assert ms >= bound_ms, f"a kernel time of {ms} ms reads below its bound of {bound_ms} ms"
    note = f"bound_share={bound_ms / ms:.4f}"
    return note + (f" kernel/library={ms / library_ms:.3f}" if library_ms else "")


def _kernel_note(fa_ops, kernel, dtype, hd) -> str:
    """Which design runs, as the kernel library reports it (tensor cores or
    f32 FMAs), and the instance's registers and shared memory."""
    info = fa_ops.kernel_info(kernel, dtype, hd)
    design = "tensor-core (wgmma + TMA)" if info["tensor_cores"] else "f32-FMA"
    return (f"[{design} kernel: {info['registers']} registers/thread, "
            f"{info['local_bytes']} B local/thread, {info['smem_bytes']} B shared/block, "
            f"{info['threads']} threads/block]")


# the smoke configs' attention at phase 16's shapes (batch 2 x SMOKE_SEQ):
# llama3.2-1b's 4/2 heads causal, recurrentgemma-9b's 4/1 with window 16
SMOKE_GQA, SMOKE_MQA = (4, 2, 16), (4, 1, 16)
SMOKE_CASE = f"smoke hd=16 causal B=2 S=T={SMOKE_SEQ} bfloat16"


def _flash_phase(torch, F, fa_ops, gen):
    llama, hybrid = (32, 8, 64), (16, 1, 256)
    cases = [  # (role, name, B, S=T, (H, KV, hd), window, dtype)
        ("serve", "path S=T=512 causal bf16", 1, 512, llama, None, torch.bfloat16),
        ("", "ragged S=T=300 causal bf16", 1, 300, llama, None, torch.bfloat16),
        ("", "window=128 S=T=512 bf16", 1, 512, llama, 128, torch.bfloat16),
        ("", "f32 S=T=512 causal", 1, 512, llama, None, torch.float32),
        ("train", f"training path B={TRAIN_BATCH} S=T={TRAIN_SEQ} causal bf16", TRAIN_BATCH,
         TRAIN_SEQ, llama, None, torch.bfloat16),
        ("hybrid", "hybrid path hd=256 MQA S=T=2560 window=2048 bf16", 1, 2560, hybrid, 2048,
         torch.bfloat16),
        ("", "hybrid hd=256 MQA S=T=512 window=2048 bf16", 1, 512, hybrid, 2048, torch.bfloat16),
    ] + [
        ("", f"smoke hd=16 {name} B=2 S=T={SMOKE_SEQ} {_dtype_name(dtype)}", 2, SMOKE_SEQ,
         heads, window, dtype)
        for name, heads, window in (("causal", SMOKE_GQA, None),
                                    ("MQA window=16", SMOKE_MQA, 16))
        for dtype in (torch.bfloat16, torch.float32)
    ]
    rows = []
    for role, name, b, s, (h, kv, hd), window, dtype in cases:
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
        rows.append(dict(role=role, case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        _print(f"[flash] {name}: max_abs_err={err:.3e} lse_err="
               f"{(lse - ref_lse).abs().max().item():.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}) "
               f"library_ms={library_ms:.5f} {_shares(ms, bound_ms, library_ms)} "
               f"{_kernel_note(fa_ops, 'flash_fwd', dtype, hd)}")
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
    return rows


def _role(rows, role):
    return next(r for r in rows if r.get("role") == role)


def _rmsnorm_phase(torch, F, rn_ops, gen):
    # the serving path first, the training path (batch x seq rows) last
    cases = [(512, 2048), (300, 2048), (N_SLOTS, 2048), (512 * 32, 64),
             (TRAIN_BATCH * TRAIN_SEQ, 2048)]
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
               f"library_ms={library_ms:.5f} {_shares(ms, bound_ms, library_ms)}")
    return rows


def _scope(sess, name):
    for root in sess.tree():
        for _, node in root.walk():
            if node.name == name:
                return node.count, node.inclusive
    raise KeyError(name)


def _hold(torch, got, want, tol):
    """``tol``: ``("elementwise", atol)`` with MODEL_RTOL, or ``("relnorm",
    limit)`` on ||got - want|| / ||want||; returns the max abs difference."""
    kind, limit = tol
    if kind == "elementwise":
        torch.testing.assert_close(got, want, atol=limit, rtol=MODEL_RTOL)
    else:
        rel = ((got - want).norm() / want.norm()).item()
        assert rel < limit, (rel, limit)
    return (got - want).abs().max().item()


def _serve_phase(torch, K, arch, prompt_lens, per_prefill, per_call, shape, tol, *,
                 smoke=False, n_requests=N_REQUESTS, max_new=MAX_NEW, n_slots=N_SLOTS):
    """Serve ``arch`` at full width (its smoke config with ``smoke``) through
    the kernels; the launch counts must equal ``per_prefill[k] x prefills +
    per_call[k] x (prefills + decode steps)`` for every kernel ``k`` (0 where
    neither names it)."""
    import numpy as np

    from repro_torch.launch.serve import make_requests, run_serving
    from repro_torch.models import model as M
    from repro_torch.timing import TimingSession

    tag = f"[serve {arch}{' smoke' if smoke else ''}]"
    sess = TimingSession()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(K)
    t0 = time.perf_counter()
    with sess:
        engine = run_serving(
            arch, n_requests, prompt_lens, max_new,
            n_slots=n_slots, seed=SEED, session=sess, smoke=smoke,
            attn_impl="pallas", norm_impl="fused", seq_impl="pallas", dtype="bfloat16",
            device="cuda",
        )
    wall = time.perf_counter() - t0
    launches = _read_counters(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cfg = engine.cfg
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.vocab_size, cfg.window)
    assert got == shape, (got, shape)
    n_prefill, prefill_s = _scope(sess, "serve/prefill")
    n_decode, decode_s = _scope(sess, "serve/decode")
    stats = engine.stats()
    results = sorted(engine.completed, key=lambda r: r.rid)
    assert len(results) == n_requests and stats["shed"] == 0.0, stats
    assert all(r.status == "completed" and len(r.tokens) == max_new for r in results)
    assert n_prefill == n_requests, n_prefill
    expected = {name: per_prefill.get(name, 0) * n_prefill
                + per_call.get(name, 0) * (n_prefill + n_decode) for name, _, _ in COUNTERS}
    assert launches == expected, (launches, expected, n_prefill, n_decode)
    _print(f"{tag} {n_requests} requests, prompts {prompt_lens}, max_new {max_new}, "
           f"{n_slots} slots: wall_s={wall:.3f} prefills={n_prefill} decode_steps={n_decode} "
           f"launches={launches}")
    _print(f"{tag} tokens_per_s={stats['throughput_tokens_per_s']:.3f} "
           f"p95_ttft_s={stats['p95_ttft_s']:.5f} p95_latency_s={stats['p95_latency_s']:.5f} "
           f"timer serve/prefill_s={prefill_s:.5f} serve/decode_s={decode_s:.5f} "
           f"max_memory_allocated_GB={peak_gb:.3f}")

    # the served model against itself on the plain path, on the card
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref", seq_impl="parallel")
    requests = make_requests(cfg.vocab_size, n_requests, prompt_lens, max_new,
                             np.random.default_rng(SEED))
    exact = 0
    worst = 0.0
    worst_rel = 0.0
    spread = 0.0  # the plain path against itself under another recurrence order
    paths = (cfg, plain) + ((plain.replace(seq_impl="ref"),) if tol[0] == "relnorm" else ())
    for req, res in zip(requests, results):
        tokens = torch.tensor([req.prompt], dtype=torch.int32, device="cuda")
        outs = []
        for c in paths:
            cache = M.init_cache(c, 1, engine.max_seq, device="cuda")
            cache, logits = M.prefill(c, engine.params, {"tokens": tokens}, cache)
            outs.append((cache, logits[0, : c.vocab_size].float()))
        (cache_k, lk), (cache_p, lp) = outs[:2]
        if len(outs) == 3:
            spread = max(spread, ((outs[2][1] - lp).norm() / lp.norm()).item())
        assert lk.shape == (cfg.vocab_size,) and bool(torch.isfinite(lk).all())
        worst = max(worst, _hold(torch, lk, lp, tol))
        worst_rel = max(worst_rel, ((lk - lp).norm() / lp.norm()).item())
        first = res.tokens[0]
        assert int(lk.argmax()) == first, (req.rid, int(lk.argmax()), first)
        exact += int(lp.argmax()) == first
        if req.rid == 0:  # one decode step on each path
            step = torch.tensor([[first]], dtype=torch.int32, device="cuda")
            _, dk = M.decode_step(cfg, engine.params, cache_k, step)
            _, dp = M.decode_step(plain, engine.params, cache_p, step)
            _hold(torch, dk.float(), dp.float(), tol)
        del outs, cache_k, cache_p
    spread_note = (f"; plain path vs itself with seq_impl=ref: max_rel_l2={spread:.4e}"
                   if len(paths) == 3 else "")
    _print(f"{tag} prefill logits vs plain path: max_abs_diff={worst:.4f} "
           f"max_rel_l2={worst_rel:.4e} (tolerance {tol}{spread_note}); first token equal "
           f"on {exact}/{n_requests}")
    return launches, engine, sess


def _f32_phase(torch, arch, n_layers, prompt_lens):
    """The served architecture in f32 at full width (``n_layers`` deep, seeded
    random weights): prefill logits of the kernel path against the plain path
    on the card, elementwise at the f32 model tolerance, for a prompt of each
    length."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).replace(
        dtype="float32", n_layers=n_layers, attn_impl="pallas", norm_impl="fused",
        seq_impl="pallas")
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref", seq_impl="parallel")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    rng = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    for n in prompt_lens:
        tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=rng, device="cuda",
                               dtype=torch.int32)
        logits = []
        for c in (cfg, plain):
            cache = M.init_cache(c, 1, n + 8, device="cuda")
            logits.append(M.prefill(c, params, {"tokens": tokens}, cache)[1][0, : c.vocab_size])
        torch.testing.assert_close(logits[0], logits[1], atol=F32_ATOL, rtol=F32_ATOL)
        worst = max(worst, (logits[0] - logits[1]).abs().max().item())
    _print(f"[f32 {arch}] {n_layers} layers at full width, f32, prompts {prompt_lens}: kernel "
           f"vs plain path prefill logits max_abs_diff={worst:.3e} (atol = rtol = {F32_ATOL})")
    del params


def _free(torch) -> None:
    """Release what the last phase held: an engine and its control loop
    reference each other, so only the cycle collector frees its weights."""
    gc.collect()
    torch.cuda.empty_cache()


def _profile_phase(torch, engine, sess, prompt_lens, tag="[profile]"):
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
            0, engine.cfg.vocab_size, prompt_lens[i % len(prompt_lens)])],
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
    _print(f"{tag} warm window: {len(requests)} requests, wall_s={wall:.4f} "
           f"device_kernel_s={device_s:.4f} device_busy_share={device_s / wall:.4f}; {phases}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        _print(f"{tag}   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")


def _rglru_phase(torch, rg_ops, gen):
    cases = [  # (name, B, S, D, dtype, with h0); the path first
        ("path (1, 2560, 4096) f32 h0", 1, 2560, 4096, torch.float32, True),
        ("(1, 512, 4096) f32 h0", 1, 512, 4096, torch.float32, True),
        ("ragged (1, 300, 4096) f32", 1, 300, 4096, torch.float32, False),
        ("(4, 1024, 4096) f32 h0", 4, 1024, 4096, torch.float32, True),
        ("(1, 2560, 4096) bf16 h0", 1, 2560, 4096, torch.bfloat16, True),
    ]
    rows = []
    for name, b, s, d, dtype, with_h0 in cases:
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=DEVICE)).to(dtype)
        x = torch.randn((b, s, d), generator=gen, device=DEVICE).to(dtype)
        h0 = torch.randn((b, d), generator=gen, device=DEVICE) if with_h0 else None
        before = rg_ops.launches
        y, h = rg_ops.rglru_fwd(a, x, h0)
        torch.cuda.synchronize()
        assert rg_ops.launches == before + 1, (name, rg_ops.launches - before)
        ref_y, ref_h = rg_ops.rglru_fwd_plain(a, x, h0)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(h, ref_h, atol=2e-5, rtol=2e-5)
        err = max((y.float() - ref_y.float()).abs().max().item(), (h - ref_h).abs().max().item())
        bit_equal = torch.equal(y, ref_y) and torch.equal(h, ref_h)  # printed, not asserted
        ms = _device_ms(torch, lambda: rg_ops.rglru_fwd(a, x, h0))
        plain_ms = _device_ms(torch, lambda: rg_ops.rglru_fwd_plain(a, x, h0), reps=3, inner=2)
        n_bytes = sum(t.numel() * t.element_size() for t in (a, x, y, h)) + (
            0 if h0 is None else h0.numel() * 4)
        bound_ms, bound_by = _bound_ms(n_bytes, 2.0 * b * s * d, "f32")
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        blocks, threads = rg_ops.kernel_plan(b, s, d)
        _print(f"[rglru] {name}: max_abs_err={err:.3e} bit_equal={bit_equal} "
               f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
               f"({bound_by}; {n_bytes / 1e6:.1f} MB) library_ms=None (no single PyTorch call) "
               f"{_shares(ms, bound_ms)} [1 counted launch a call: one kernel of {blocks} "
               f"blocks x {threads} threads, after a memset of its look-back words]")
        del a, x, y, h, ref_y, ref_h
    return rows


def _wkv6_phase(torch, wk_ops, gen):
    cases = [  # (name, B, S, H, K = V, r/k/v dtype); the path first; w f32, a state
        ("path (1, 512, 32, 64) bf16, f32 w, state", 1, 512, 32, 64, torch.bfloat16),
        ("ragged (1, 300, 32, 64) bf16", 1, 300, 32, 64, torch.bfloat16),
        ("(4, 1024, 32, 64) bf16", 4, 1024, 32, 64, torch.bfloat16),
        ("(1, 512, 32, 64) all f32", 1, 512, 32, 64, torch.float32),
    ]
    rows = []
    for name, b, s, h, k, dtype in cases:
        r, kk, v = (torch.randn((b, s, h, k), generator=gen, device=DEVICE).to(dtype)
                    for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((b, s, h, k), generator=gen, device=DEVICE)))
        u = 0.5 * torch.randn((h, k), generator=gen, device=DEVICE)
        state = torch.randn((b, h, k, k), generator=gen, device=DEVICE)
        before = wk_ops.launches
        y, s_out = wk_ops.wkv6_fwd(r, kk, v, w, u, state)
        torch.cuda.synchronize()
        assert wk_ops.launches == before + 1, (name, wk_ops.launches - before)
        ref_y, ref_s = wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(s_out, ref_s, atol=2e-5, rtol=2e-5)
        err = max((y.float() - ref_y.float()).abs().max().item(),
                  (s_out - ref_s).abs().max().item())
        state_equal = torch.equal(s_out, ref_s)  # printed, not asserted
        ms = _device_ms(torch, lambda: wk_ops.wkv6_fwd(r, kk, v, w, u, state))
        plain_ms = _device_ms(torch, lambda: wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state),
                              reps=3, inner=2)
        n_bytes = sum(t.numel() * t.element_size() for t in (r, kk, v, w, u, state, y, s_out))
        # per state element and step: r_i S_ij (2 flops), w_i S_ij + k_i v_j (3)
        flops = 5.0 * b * s * h * k * k
        bound_ms, bound_by = _bound_ms(n_bytes, flops, "f32")
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        plan = ", ".join(f"{part} {blocks} x {threads} ({smem} B shared)"
                         for part, blocks, threads, smem in wk_ops.kernel_plan(b, s, h, k))
        _print(f"[wkv6] {name}: max_abs_err={err:.3e} state_bit_equal={state_equal} "
               f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
               f"({bound_by}; {n_bytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP) "
               f"library_ms=None (no single PyTorch call) {_shares(ms, bound_ms)} "
               f"[1 counted launch a call: 3 kernels, blocks x threads: {plan}]")
        del r, kk, v, w, y, s_out, ref_y, ref_s
    return rows


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def _flash_bwd_phase(torch, F, fa_ops, gen):
    llama = (32, 8, 64)
    cases = [  # (name, B, S=T, (H, KV, hd), window, dtype)
        ("path B=4 S=T=1024 causal bf16", TRAIN_BATCH, TRAIN_SEQ, llama, None, torch.bfloat16),
        ("ragged B=4 S=T=300 causal bf16", TRAIN_BATCH, 300, llama, None, torch.bfloat16),
        ("window=128 B=4 S=T=1024 bf16", TRAIN_BATCH, TRAIN_SEQ, llama, 128, torch.bfloat16),
        ("f32 B=4 S=T=1024 causal", TRAIN_BATCH, TRAIN_SEQ, llama, None, torch.float32),
    ] + [
        (f"smoke hd=16 {name} B=2 S=T={SMOKE_SEQ} {_dtype_name(dtype)}", 2, SMOKE_SEQ, heads,
         window, dtype)
        for name, heads, window in (("causal", SMOKE_GQA, None),
                                    ("MQA window=16", SMOKE_MQA, 16))
        for dtype in (torch.bfloat16, torch.float32)
    ]
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, b, s, (h, kv, hd), window, dtype in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((b, s, kv, hd), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((b, s, kv, hd), generator=gen, device=DEVICE).to(dtype)
        do = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
        mask = dict(causal=True, window=window)
        out, lse = fa_ops.flash_fwd(q, k, v, **mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        _print(f"[flash_bwd] {name}: forward out max_abs_err="
               f"{(out.float() - ref_out.float()).abs().max().item():.3e} lse_err="
               f"{(lse - ref_lse).abs().max().item():.3e}")
        del ref_out, ref_lse
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = fa_ops.flash_bwd_dq(*args, **mask)
        dk, dv = fa_ops.flash_bwd_dkv(*args, **mask)
        torch.cuda.synchronize()
        ref_dq = fa_ops.flash_bwd_dq_plain(*args, **mask)
        ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(*args, **mask)
        tol = GRAD_TOL[_dtype_name(dtype)]
        stats = []
        for grad, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
            scale = got.float().abs().max().item()
            assert scale > 0 and ref.float().abs().max().item() > 0, (name, grad)
            stats.append(f"{grad}: max|kernel|={scale:.4g} "
                         f"bit-equal={(got == ref).float().mean().item():.4f}")
        _print(f"[flash_bwd] {name}: " + "; ".join(stats))
        err_dq = (dq.float() - ref_dq.float()).abs().max().item()
        err_dkv = max((dk.float() - ref_dk.float()).abs().max().item(),
                      (dv.float() - ref_dv.float()).abs().max().item())

        pos = torch.arange(s, device=DEVICE)
        ok = pos[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[None, :] > pos[:, None] - window
        pairs = int(ok.sum())
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if window is None else ok, is_causal=window is None,
            enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        # one call computes dq, dk and dv: the yardstick of both kernels
        library_ms = _device_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        peak = "bf16_tensor" if dtype == torch.bfloat16 else "f32"
        nbytes = lambda *xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
        for kernel, matmuls, moved, err, fn, plain in (
            ("flash_bwd_dq", 3, nbytes(q, k, v, do, lse, delta, dq), err_dq,
             lambda: fa_ops.flash_bwd_dq(*args, **mask),
             lambda: fa_ops.flash_bwd_dq_plain(*args, **mask)),
            ("flash_bwd_dkv", 4, nbytes(q, k, v, do, lse, delta, dk, dv), err_dkv,
             lambda: fa_ops.flash_bwd_dkv(*args, **mask),
             lambda: fa_ops.flash_bwd_dkv_plain(*args, **mask)),
        ):
            ms = _device_ms(torch, fn)
            plain_ms = _device_ms(torch, plain)
            bound_ms, bound_by = _bound_ms(moved, 2.0 * matmuls * b * h * pairs * hd, peak)
            rows[kernel].append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms))
            note = _kernel_note(fa_ops, kernel, dtype, hd)
            _print(f"[{kernel}] {name}: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
                   f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}; "
                   f"{moved / 1e6:.1f} MB, {2e-9 * matmuls * b * h * pairs * hd:.1f} GFLOP) "
                   f"library_ms={library_ms:.5f} (SDPA backward: dq, dk, dv) "
                   f"{_shares(ms, bound_ms, library_ms)} {note}")
        del sdpa_out, qt, kt, vt
    return rows


def _rmsnorm_bwd_phase(torch, F, rn_ops, gen):
    cases = [(4096, 2048, torch.bfloat16), (300, 2048, torch.bfloat16),
             (16384, 64, torch.bfloat16), (7, 100, torch.float32)]
    rows = []
    for n, d, dtype in cases:
        x = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)).to(dtype)
        dy = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
        dx, dw = rn_ops.rms_norm_bwd(x, w, dy, 1e-5)
        torch.cuda.synchronize()
        ref_dx, ref_dw = rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5)
        name = _dtype_name(dtype)
        tol_dx, tol_dw = KERNEL_TOL[name], DW_TOL[name]
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol_dx, rtol=tol_dx)
        torch.testing.assert_close(dw, ref_dw, atol=tol_dw, rtol=tol_dw)
        assert torch.equal(rn_ops.rms_norm_bwd(x, w, dy, 1e-5)[1], dw)  # fixed-order dw
        err = max((dx.float() - ref_dx.float()).abs().max().item(),
                  (dw - ref_dw).abs().max().item())
        ms = _device_ms(torch, lambda: rn_ops.rms_norm_bwd(x, w, dy, 1e-5))
        plain_ms = _device_ms(torch, lambda: rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5))
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.rms_norm(xl, (d,), wl, 1e-5)
        library_ms = _device_ms(torch, lambda: torch.autograd.grad(
            y, (xl, wl), dy, retain_graph=True))
        moved = 3 * x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * d
        bound_ms, bound_by = _bound_ms(moved, 10.0 * n * d, "f32")
        rows.append(dict(case=f"({n}, {d}) {name}", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        plan = rn_ops.bwd_kernel_info(x, w, dy)
        _print(f"[rmsnorm_bwd] ({n}, {d}) {name}: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}; "
               f"{moved / 1e6:.1f} MB) library_ms={library_ms:.5f} "
               f"{_shares(ms, bound_ms, library_ms)} [{plan['launches']} launch(es) a call, "
               f"{plan['blocks']} blocks of {plan['threads']} threads, {plan['registers']} "
               f"registers/thread, {plan['local_bytes']} B local/thread, {plan['smem_bytes']} B "
               f"shared/block]")
        del y, xl, wl
    return rows


# (kernel, module of its wrapper, counter attribute)
COUNTERS = (("flash_fwd", "fa", "launches"), ("flash_bwd_dq", "fa", "dq_launches"),
            ("flash_bwd_dkv", "fa", "dkv_launches"), ("rmsnorm_fwd", "rn", "launches"),
            ("rmsnorm_bwd", "rn", "bwd_launches"), ("rglru_fwd", "rg", "launches"),
            ("wkv6_fwd", "wk", "launches"))


def _zero_counters(K) -> None:
    for _, mod, attr in COUNTERS:
        setattr(getattr(K, mod), attr, 0)


def _read_counters(K) -> dict[str, int]:
    return {name: getattr(getattr(K, mod), attr) for name, mod, attr in COUNTERS}


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named_leaves(value, f"{prefix}/{key}" if prefix else key)
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _named_leaves(value, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _train_phase(torch, K, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 start=0, tag=None, **extra):
    """Train llama3.2-1b (its smoke config with ``smoke``) through the
    kernels; the launch counts must equal the per-step counts x the steps
    that ran (``steps - start``: a run restored at label ``start`` runs the
    rest).  ``extra`` goes to ``TrainSettings``.  Returns the launch counts,
    the config, the losses of the steps that ran, the summary and the timer
    database (not the session: its scheduler's routines hold the run's
    state, 17.3 GB on the card at full width)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import TimerLogger
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.models import model as M
    from repro_torch.timing import TimingSession

    cfg = (get_smoke_config if smoke else get_config)("llama3.2-1b").replace(
        attn_impl="pallas", norm_impl="fused", remat="dots", dtype="bfloat16")
    n_layers = cfg.n_layers
    shape = (n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
             cfg.vocab_size, cfg.tied_embeddings)
    assert shape == ((2, 64, 4, 2, 16, 256, True) if smoke
                     else (16, 2048, 32, 8, 64, 128256, True)), cfg
    tag = tag or ("[train smoke]" if smoke else "[train]")
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "train.jsonl")
        settings = TrainSettings(
            arch="llama3.2-1b", smoke=smoke, steps=steps, global_batch=batch,
            seq_len=seq, data_mode="copy", seed=SEED, report_every=0,
            log_path=log_path, device=DEVICE, **extra,
        )
        sess = TimingSession()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(K)
        t0 = time.perf_counter()
        summary = run_training(settings, cfg=cfg, session=sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(K)
        records = TimerLogger(log_path, sess.db).read_all()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_step = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "rmsnorm_fwd": 4 * n_layers,
                "rmsnorm_bwd": 2 * n_layers, "rglru_fwd": 0, "wkv6_fwd": 0}
    ran = steps - start
    assert launches == {k: v * ran for k, v in per_step.items()}, launches
    assert summary["iterations"] == steps and len(records) == ran, summary
    assert [r["iteration"] for r in records] == list(range(start, steps)), records
    losses = [r["extra"]["loss"] for r in records]
    assert all(math.isfinite(x) for x in losses), losses
    cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
    step_s = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = batch * seq
    active = M.param_counts(cfg)[1]
    mfu = 6.0 * active * tokens / median_s / PEAK_FLOPS["bf16_tensor"]
    _print(f"{tag} llama3.2-1b {'smoke config' if smoke else 'full width'}, bf16, remat dots, "
           f"batch {batch} x seq {seq}, steps {start + 1}-{steps}: wall_s={wall:.3f} "
           f"launches={launches} (per step {per_step})")
    _print(f"{tag} losses={[round(x, 5) for x in losses]} "
           f"grad_norm={summary['final_metrics']['grad_norm']:.5f}")
    if smoke:  # a toy model's step times are launch overhead
        return launches, cfg, losses, summary, sess.db
    _print(f"{tag} step_s={[round(x, 5) for x in step_s]} "
           f"median_s(steps {start + 2}-{steps})={median_s:.5f} "
           f"tokens_per_s(EVOL, all steps)={ran * tokens / cum[-1]:.1f} "
           f"tokens_per_s(median step)={tokens / median_s:.1f} "
           f"mfu(6*{active}*tokens vs 989 TFLOP/s)={mfu:.4f} "
           f"max_memory_allocated_GB={peak_gb:.3f}")
    return launches, cfg, losses, summary, sess.db


def _train_compare_phase(torch, cfg, batch_size=TRAIN_BATCH, seq=TRAIN_SEQ,
                         loss_rtol=TRAIN_RTOL, leaf_rtol=LEAF_RTOL, label="[train]"):
    """One loss-and-gradient step, kernel path vs plain path, same weights and
    batch, on the card."""
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import global_norm

    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch_size, mode="copy",
                                        seed=SEED)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    names = [name for name, _ in _named_leaves(params)]
    out = {}
    for path, c in (("kernel", cfg), ("plain", plain)):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss, _ = M.loss_fn(c, tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, leaves)
        out[path] = (loss.item(), global_norm(list(grads)).item(), grads)
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out["kernel"], out["plain"]
    rel = {}
    for name, a, b in zip(names, g_k, g_p):
        for tag, g in (("kernel", a), ("plain", b)):
            assert bool(torch.isfinite(g).all()) and g.abs().max().item() > 0, (tag, name)
        rel[name] = ((a.float() - b.float()).norm() / b.float().norm()).item()
    assert abs(loss_k - loss_p) <= loss_rtol * abs(loss_p), (loss_k, loss_p)
    assert abs(gn_k - gn_p) <= loss_rtol * gn_p, (gn_k, gn_p)
    worst = max(rel, key=rel.get)
    assert rel[worst] < leaf_rtol, rel
    _print(f"{label} one step on the card, kernel vs plain path: loss {loss_k:.6f} vs "
           f"{loss_p:.6f}; grad_norm {gn_k:.6f} vs {gn_p:.6f}; every leaf finite and nonzero; "
           f"worst leaf relative error {rel[worst]:.3e} ({worst}; limit {leaf_rtol})")
    _print(f"{label} relative error by leaf: "
           + ", ".join(f"{k}={v:.2e}" for k, v in rel.items()))
    return params, batch


def _train_profile_phase(torch, cfg, params, batch):
    """Where a warm training step's time goes: one warm-up step, then one
    step under ``torch.profiler`` (device busy share = summed kernel time over
    the step's wall time, the profiler's host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig, init_opt_state

    built = make_train_step(cfg, ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                            peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    opt_state = init_opt_state(AdamWConfig(), params)
    params, opt_state, metrics = built.fn(params, opt_state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    _print(f"[profile-train] one warm step: wall_s={wall:.4f} device_kernel_s={device_s:.4f} "
           f"device_busy_share={device_s / wall:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _print(f"[profile-train]   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} "
               f"{e.key[:90]}")


def _smoke_phase(torch, K):
    """Head_dim 16 through the flash kernels: serve the llama3.2-1b and
    recurrentgemma-9b smoke configs (bf16, 2 layers / 4 layers of d_model 64
    with 4 heads of 16; recurrentgemma's MQA with window 16) through all the
    kernels, 4 requests of SMOKE_SEQ-token prompts, 8 new tokens, 2 slots,
    with exact launch counts (one flash forward per attention layer and
    prefill, one RG-LRU per recurrent layer and prefill, two RMSNorms per
    layer and call) and every prefill's logits against the plain path at the
    repo's bf16 model tolerance (tests/test_model_pallas_path.py: these
    configs, 128 tokens, atol 0.1, rtol 0.05); then train the llama3.2-1b
    smoke config SMOKE_STEPS steps (bf16, remat dots, batch 2 x SMOKE_SEQ)
    with exact flash forward/dq/dkv and RMSNorm launch counts and finite
    losses, and hold one loss-and-gradient step against the plain path in
    bf16 (the training phase's TRAIN_RTOL and LEAF_RTOL) and in f32 (loss
    and gradient norm to 1e-4 relative, each leaf to 1e-3 in relative norm,
    as tests/test_torch_cuda.py's every-leaf test).  The kernels' own
    instances at these shapes are held elementwise in phases 2 and 6."""
    from repro_torch.configs import get_smoke_config

    launches = {}
    for arch in ("llama3.2-1b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        kinds = cfg.layer_kinds()
        assert cfg.resolved_head_dim == 16, cfg
        launches[arch], engine, _ = _serve_phase(
            torch, K, arch, (SMOKE_SEQ,),
            {"flash_fwd": sum(kind.startswith("attn") for kind in kinds),
             "rglru_fwd": kinds.count("rglru")},
            {"rmsnorm_fwd": 2 * cfg.n_layers},
            (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, 16, cfg.vocab_size,
             cfg.window),
            ("elementwise", MODEL_ATOL), smoke=True, n_requests=4, max_new=8, n_slots=2)
        del engine
    launches["train"], cfg, *_ = _train_phase(torch, K, smoke=True, steps=SMOKE_STEPS,
                                              batch=2, seq=SMOKE_SEQ)
    _train_compare_phase(torch, cfg, batch_size=2, seq=SMOKE_SEQ, label="[train smoke bf16]")
    _train_compare_phase(torch, cfg.replace(dtype="float32"), batch_size=2, seq=SMOKE_SEQ,
                         loss_rtol=1e-4, leaf_rtol=1e-3, label="[train smoke f32]")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        _print(f"[smoke] {name} at head_dim 16: "
               + ", ".join(f"{_dtype_name(dtype)} {_kernel_note(K.fa, name, dtype, 16)}"
                           for dtype in (torch.bfloat16, torch.float32)))
    return launches


def _ckpt_root() -> str:
    """The first local directory with room for a full-width training state:
    the temporary directory, else the checkout's gitignored ``build/``."""
    for root in (tempfile.gettempdir(), str(ROOT / "build")):
        os.makedirs(root, exist_ok=True)
        usage = shutil.disk_usage(root)
        _print(f"[ckpt] {root}: total {usage.total / 1e9:.1f} GB, free {usage.free / 1e9:.1f} GB")
        if usage.free >= CKPT_FREE_BYTES:
            return root
    raise RuntimeError(f"no local directory with {CKPT_FREE_BYTES / 1e9:.0f} GB free")


def _payload_bytes(ckpt_path: str) -> int:
    """Array bytes of a checkpoint from its manifest (what ``io_bytes`` counts)."""
    import numpy as np

    with open(os.path.join(ckpt_path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return sum(math.prod(e["shape"]) * np.dtype(e["stored_dtype"]).itemsize for e in leaves)


def _ckpt_phase(torch, K, train_losses):
    """Phase 17: checkpoint and resume full-width llama3.2-1b (module
    docstring).  ``train_losses`` are phase 8's six losses."""
    from repro_torch.checkpoint import CheckpointManager, validate_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.clocks import counter_channel
    from repro_torch.models import model as M
    from repro_torch.monitor import parse_exposition

    root = _ckpt_root()
    _print(f"[ckpt] checkpoints under {root}")

    # 1. the params' round trip through the manager, onto the card
    cfg = get_config("llama3.2-1b").replace(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    named = dict(_named_leaves(params))
    tmp = tempfile.mkdtemp(prefix="ckpt_params_", dir=root)
    try:
        mgr = CheckpointManager(tmp, keep_n=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = mgr.save(0, params)
        mgr.wait()
        write_s = time.perf_counter() - t0
        path = mgr.checkpoints()[-1][1]
        file_bytes = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
        t0 = time.perf_counter()
        validate_checkpoint(path)
        validate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, tree, _ = mgr.restore_latest(device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mgr.close()
        got = dict(_named_leaves(tree))
        assert step == 0 and sorted(got) == sorted(named), sorted(got)
        for name, want in named.items():
            assert got[name].device.type == "cuda", name
            assert got[name].dtype == want.dtype == torch.bfloat16, name
            assert torch.equal(got[name], want), name
        n_params = sum(t.numel() for t in named.values())
        del tree, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, named
    _free(torch)
    _print(f"[ckpt] params round trip: {n_params} bf16 params, every leaf torch.equal after "
           f"restore_latest(device='cuda'), bf16 kept; bytes={stats['nbytes']:.0f} "
           f"(files {file_bytes}) blocking_s={stats['blocking_seconds']:.4f} "
           f"write_s(save+wait)={write_s:.4f} ({file_bytes / write_s / 1e9:.3f} GB/s) "
           f"validate_s={validate_s:.4f} ({file_bytes / validate_s / 1e9:.3f} GB/s) "
           f"restore_s(validate+load onto the card)={restore_s:.4f} "
           f"load_s(restore - validate)={restore_s - validate_s:.4f}")

    # 2. run A saves at shutdown (label 3), run B restores it and trains on
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_train_", dir=root)
    textfile, status_path = ckpt_dir + ".prom", ckpt_dir + ".json"
    try:
        io_before = counter_channel("io_bytes")
        launches_a, _, losses_a, summary_a, db_a = _train_phase(
            torch, K, steps=CKPT_STEPS, tag="[ckpt run A]", lr_total_steps=TRAIN_STEPS,
            ckpt_dir=ckpt_dir, ckpt_mode="fixed", ckpt_every=1000,
            metrics_textfile=textfile, status_path=status_path)
        label = f"step_{CKPT_STEPS:08d}"
        assert sorted(os.listdir(ckpt_dir)) == [label], os.listdir(ckpt_dir)
        written = _payload_bytes(os.path.join(ckpt_dir, label))
        write_timer = db_a.get("CHECKPOINT/adaptcheck::write")
        shutdown_s = db_a.get("SHUTDOWN/driver::shutdown").seconds()
        # 3. the monitor surfaces of run A
        with open(textfile) as f:
            exp = parse_exposition(f.read())
        io_bytes = exp.value("repro_counter_total", channel="io_bytes") - io_before
        assert io_bytes == written, (io_bytes, written)
        saved = exp.value("repro_checkpoint_write_bytes_total")
        blocking_s = exp.value("repro_checkpoint_blocking_seconds_total")
        assert exp.value("repro_checkpoint_saves_total") == 1.0 and write_timer.count == 1
        with open(status_path) as f:
            status = json.load(f)["status"]
        assert status["iteration"] == CKPT_STEPS - 1, status
        assert status["loss"] == losses_a[-1], (status, losses_a)
        _free(torch)

        launches_b, _, losses_b, summary_b, db_b = _train_phase(
            torch, K, steps=TRAIN_STEPS, start=CKPT_STEPS, tag="[ckpt run B]",
            lr_total_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir, ckpt_mode="off", restore=True)
        resume = summary_b["resume"]
        assert (resume["selected_step"], resume["n_valid"], resume["n_quarantined"]) == \
            (CKPT_STEPS, 1, 0), resume
        assert sorted(os.listdir(ckpt_dir)) == [label], os.listdir(ckpt_dir)
        restore_timer = db_b.get("STARTUP/restore").seconds()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        for leftover in (textfile, status_path):
            if os.path.exists(leftover):
                os.remove(leftover)
    _free(torch)
    # run A is phase 8's first three steps, run B its last three
    for got, want in ((losses_a, train_losses[:CKPT_STEPS]),
                      (losses_b, train_losses[CKPT_STEPS:])):
        for a, b in zip(got, want):
            assert abs(a - b) <= TRAIN_RTOL * abs(b), (got, want)
    diff_b = max(abs(a - b) for a, b in zip(losses_b, train_losses[CKPT_STEPS:]))
    _print(f"[ckpt] run A saved label {CKPT_STEPS} at shutdown: bytes={saved:.0f} "
           f"(io_bytes sample {io_bytes:.0f} = the checkpoint's array bytes) "
           f"blocking_s={blocking_s:.4f} CHECKPOINT/adaptcheck::write_s={write_timer.seconds():.4f} "
           f"ckpt_fraction={summary_a['ckpt_fraction']:.4f} "
           f"SHUTDOWN_s(blocking save + wait until durable)={shutdown_s:.4f} "
           f"({written / max(shutdown_s - blocking_s, 1e-9) / 1e9:.3f} GB/s written after the "
           f"snapshot); textfile parses, status iteration {status['iteration']}")
    _print(f"[ckpt] run B restored label {resume['selected_step']} (valid {resume['n_valid']}, "
           f"quarantined {resume['n_quarantined']}): STARTUP/restore_s(validate+load onto the "
           f"card)={restore_timer:.4f} ({written / restore_timer / 1e9:.3f} GB/s), wrote nothing")
    _print(f"[ckpt] losses steps 4-6 resumed {[round(x, 6) for x in losses_b]} vs phase 8 "
           f"{[round(x, 6) for x in train_losses[CKPT_STEPS:]]}: max |diff| {diff_b:.3e} "
           f"(limit {TRAIN_RTOL} relative), bitwise equal: {losses_b == train_losses[CKPT_STEPS:]}; "
           f"steps 1-3 of run A bitwise equal to phase 8's: "
           f"{losses_a == train_losses[:CKPT_STEPS]}")
    return {"run_a": launches_a, "run_b": launches_b}


def main() -> int:
    import types

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
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rwkv6 import ops as wk_ops

    K = types.SimpleNamespace(fa=fa_ops, rn=rn_ops, rg=rg_ops, wk=wk_ops)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _print(smi)
    _print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _print(f"[build] {len(COUNTERS)} kernels from {', '.join(f'{n}.cu' for n in build.SOURCES)} "
           f"built and loaded in {build.build_all():.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = _flash_phase(torch, F, fa_ops, gen)
    rms = _rmsnorm_phase(torch, F, rn_ops, gen)
    launches, engine, sess = _serve_phase(
        torch, K, "llama3.2-1b", PROMPT_LENS, {"flash_fwd": 16}, {"rmsnorm_fwd": 32},
        (16, 2048, 32, 8, 64, 128256, None), ("elementwise", MODEL_ATOL))
    _profile_phase(torch, engine, sess, PROMPT_LENS)
    del engine, sess
    _free(torch)

    flash_bwd = _flash_bwd_phase(torch, F, fa_ops, gen)
    rms_bwd = _rmsnorm_bwd_phase(torch, F, rn_ops, gen)
    torch.cuda.empty_cache()
    train_launches, cfg, train_losses, *_ = _train_phase(torch, K)
    params, batch = _train_compare_phase(torch, cfg)
    _train_profile_phase(torch, cfg, params, batch)
    del params, batch
    _free(torch)

    rglru = _rglru_phase(torch, rg_ops, gen)
    wkv6 = _wkv6_phase(torch, wk_ops, gen)
    _free(torch)
    # recurrentgemma-9b: 13 rglru and 25 attn_local layers, 2 norms each
    hybrid_launches, engine, sess = _serve_phase(
        torch, K, "recurrentgemma-9b", HYBRID_PROMPT_LENS,
        {"rglru_fwd": 13, "flash_fwd": 25}, {"rmsnorm_fwd": 76},
        (38, 4096, 16, 1, 256, 256000, 2048), ("relnorm", RECURRENT_REL))
    _profile_phase(torch, engine, sess, HYBRID_PROMPT_LENS, "[profile recurrentgemma-9b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "recurrentgemma-9b", 4, HYBRID_PROMPT_LENS)
    _free(torch)
    # rwkv6-1.6b: 24 rwkv layers, 3 norms each (ln1, the group norm, ln2)
    ssm_launches, engine, sess = _serve_phase(
        torch, K, "rwkv6-1.6b", PROMPT_LENS, {"wkv6_fwd": 24}, {"rmsnorm_fwd": 72},
        (24, 2048, 32, 32, 64, 65536, None), ("relnorm", RECURRENT_REL))
    _profile_phase(torch, engine, sess, PROMPT_LENS, "[profile rwkv6-1.6b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "rwkv6-1.6b", 24, PROMPT_LENS)
    _free(torch)
    smoke_launches = _smoke_phase(torch, K)
    _free(torch)
    ckpt_launches = _ckpt_phase(torch, K, train_losses)

    # each kernel at the shapes of its main path: the forward kernels on the
    # serving path (their launches in phase 4) and, under "train", on the
    # training path (phase 8); the backward kernels on the training path; the
    # recurrence kernels and, under "hybrid", flash at head_dim 256 on the
    # serving paths of phases 12 and 14; under "smoke", the flash kernels at
    # head_dim 16 on phase 16's paths; under "resume", the training kernels
    # on phase 17's two runs (phase 8's shapes)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    csrc = "src/repro_torch/kernels/csrc/"
    pick = lambda row: {k: row[k] for k in keys}  # noqa: E731
    # the head_dim-16 kernels on phase 16's paths: launches by path, and the
    # bf16 causal case of phases 2 and 6 at their shapes
    smoke = lambda name, rows: dict(  # noqa: E731
        launches={path: n[name] for path, n in smoke_launches.items()},
        **pick(next(r for r in rows if r["case"] == SMOKE_CASE)))
    resume = lambda name, row: dict(  # noqa: E731
        launches={run: n[name] for run, n in ckpt_launches.items()}, **pick(row))
    record = {"kernels": [
        dict(name="flash_fwd", route="cuda", source=csrc + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=launches["flash_fwd"], **pick(_role(flash, "serve")),
             train=dict(launches=train_launches["flash_fwd"], **pick(_role(flash, "train"))),
             hybrid=dict(launches=hybrid_launches["flash_fwd"], **pick(_role(flash, "hybrid"))),
             smoke=smoke("flash_fwd", flash), resume=resume("flash_fwd", _role(flash, "train"))),
        dict(name="flash_bwd_dq", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:176",
             launches=train_launches["flash_bwd_dq"], **pick(flash_bwd["flash_bwd_dq"][0]),
             smoke=smoke("flash_bwd_dq", flash_bwd["flash_bwd_dq"]),
             resume=resume("flash_bwd_dq", flash_bwd["flash_bwd_dq"][0])),
        dict(name="flash_bwd_dkv", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:242",
             launches=train_launches["flash_bwd_dkv"], **pick(flash_bwd["flash_bwd_dkv"][0]),
             smoke=smoke("flash_bwd_dkv", flash_bwd["flash_bwd_dkv"]),
             resume=resume("flash_bwd_dkv", flash_bwd["flash_bwd_dkv"][0])),
        dict(name="rmsnorm_fwd", route="cuda", source=csrc + "rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:30",
             launches=launches["rmsnorm_fwd"], **pick(rms[0]),
             train=dict(launches=train_launches["rmsnorm_fwd"], **pick(rms[-1])),
             resume=resume("rmsnorm_fwd", rms[-1])),
        dict(name="rmsnorm_bwd", route="cuda", source=csrc + "rmsnorm_bwd.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:75",
             launches=train_launches["rmsnorm_bwd"], **pick(rms_bwd[0]),
             resume=resume("rmsnorm_bwd", rms_bwd[0])),
        dict(name="rglru_fwd", route="cuda", source=csrc + "rglru.cu",
             replaces="src/repro/kernels/rglru/kernel.py:53",
             launches=hybrid_launches["rglru_fwd"], **pick(rglru[0])),
        dict(name="wkv6_fwd", route="cuda", source=csrc + "rwkv6.cu",
             replaces="src/repro/kernels/rwkv6/kernel.py:65",
             launches=ssm_launches["wkv6_fwd"], **pick(wkv6[0])),
    ]}
    _print(json.dumps(record))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
