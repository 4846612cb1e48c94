#!/usr/bin/env python3
"""Time the port's bf16 flash kernels, its RMSNorm kernels and its two
recurrence kernels on one NVIDIA card, for the ``repro_torch`` package of a
checkout (this one by default):

    python3 tools/time_flash.py [--root CHECKOUT]

``flash_fwd`` at every main path's shape (``FWD_PATH_CASES``: vlm,
moonshot, encdec and llama training and prefill (both prompt lengths), the pipeline's
microbatch, a TP rank's shard, a MoE rank's shard, a sharded server's
rank, recurrentgemma-9b's hd-256 prefill and training) and at one hd-32
shape; ``flash_bwd_dq``
and ``flash_bwd_dkv`` at the training shape and at ``chip_smoke.py``'s
ragged S=T=300 and window-128 cases, and at head_dim 256 at
recurrentgemma-9b's training path (B=1, S=T=4096, 16/1 heads, window 2048)
and ``chip_smoke.py``'s ragged S=T=300 window-128 case; ``rmsnorm_fwd`` at
``chip_smoke.py`` phase 3's bf16 cases; ``rmsnorm_bwd`` at its phase 7's
cases ((4096, 2048), the training path, (300, 2048), (16384, 64) bf16 and
(7, 100) f32); ``rglru_fwd`` at recurrentgemma-9b's prefill shapes (1, 2560,
4096) f32 and bf16 and (1, 512, 4096) f32, with h0; ``wkv6_fwd`` at
rwkv6-1.6b's (1, 512, 32, 64) and (1, 300, 32, 64), bf16 r/k/v with an f32
w and a state (``chip_smoke.py`` phases 10 and 11's draws).  Inputs are
seeded; each time is ``chip_smoke.py``'s
cold-L2 time: the median of 7 windows of 20 calls queued behind a device
sleep, each call timed by its own CUDA events after a 256 MB write that
evicts the L2.  Also the host microseconds a forward call
takes at the serving shape, where the host sets the pace: the wrapper, and
its C entry point alone (the tensor maps and the launch).  Prints the
card's name and power limit, then one JSON line: the checkout, the kernels'
build seconds and the times.

To compare two versions on one card, unpack the other commit with
``git archive`` into another directory (one that ``.gitignore`` lists, such
as ``build/parent``, when the run happens on a copy of this checkout) and
run the two in turns (old, new, new, old), each in its own process: both
packages are called ``repro_torch``.  Each checkout builds its kernels into
its own ``build/`` directory; the timer is always this checkout's.

``flash_bwd_dkv`` also at every shape a main path gives it at head_dim 64
and 128 (``DKV_PATH_CASES``: the pipeline's microbatch and a process's
stage, a TP rank's shard, encdec, llama, moonshot and vlm training, a MoE
rank's shard), each with its plan.  ``rmsnorm_fwd`` also at the vlm's
width 6144 and the encdec's width 1024 (their prefill, decode and training
rows).

``--only REGEX`` times only the cases whose key in the JSON line matches
(``re.search``): ``--only '^fwd_'`` for the forward alone.  ``--check``
first holds each forward path case against ``flash_fwd_plain`` (out 2e-2,
lse 2e-5), so a variant that is timed is also right.

With ``--dkv-splits``, also those cases and the head_dim-256 ones at every
split of the GQA group (each divisor of the group) beside the one its
planner picks (``ops.dkv_split``, replaced for the sweep), to check the
planner's rule on the card.

With ``--profile``, also the device time of each kernel a recurrence call
or a head_dim-256 dkv call launches (``torch.profiler``, 20 back-to-back
calls at each case, so a warm L2), to show which launch of a call takes its
time (the split dkv kernel against the sum of its partials).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

BWD_CASES = {  # name: (B, S = T, window), 32/8 heads of 64, causal
    "train_B4_S1024": (4, 1024, None),
    "ragged_B4_S300": (4, 300, None),
    "window128_B4_S1024": (4, 1024, 128),
}
HD256_BWD_CASES = {  # name: (B, S = T, window), 16/1 heads of 256, causal
    "hybrid_B1_S4096_w2048": (1, 4096, 2048),
    "hybrid_ragged_B1_S300_w128": (1, 300, 128),
}
DKV_PATH_CASES = {  # name: (B, S = T, H, KV, hd, causal), bf16
    "pipeline_B1_S1024_32x8_hd64": (1, 1024, 32, 8, 64, True),
    "dist_B2_S1024_16x4_hd64": (2, 1024, 16, 4, 64, True),
    "encdec_B4_S1024_16x16_hd64_noncausal": (4, 1024, 16, 16, 64, False),
    "llama_B4_S1024_32x8_hd64": (4, 1024, 32, 8, 64, True),
    "moe_dist_B2_S1024_8x8_hd128": (2, 1024, 8, 8, 128, True),
    "moonshot_B4_S1024_16x16_hd128": (4, 1024, 16, 16, 128, True),
    "vlm_B4_S1280_48x8_hd128": (4, 1280, 48, 8, 128, True),
}
FWD_PATH_CASES = {  # name: (B, S = T, H, KV, hd, causal, window), bf16
    "vlm_train_B4_S1280_48x8_hd128": (4, 1280, 48, 8, 128, True, None),
    "moonshot_train_B4_S1024_16x16_hd128": (4, 1024, 16, 16, 128, True, None),
    "encdec_train_B4_S1024_16x16_hd64_noncausal": (4, 1024, 16, 16, 64, False, None),
    "llama_train_B4_S1024_32x8_hd64": (4, 1024, 32, 8, 64, True, None),
    "vlm_prefill_B1_S768_48x8_hd128": (1, 768, 48, 8, 128, True, None),
    "moonshot_prefill_B1_S512_16x16_hd128": (1, 512, 16, 16, 128, True, None),
    "encdec_prefill_B1_S512_16x16_hd64_noncausal": (1, 512, 16, 16, 64, False, None),
    "llama_prefill_B1_S512_32x8_hd64": (1, 512, 32, 8, 64, True, None),
    "vlm_prefill_B1_S556_48x8_hd128": (1, 556, 48, 8, 128, True, None),
    "moonshot_prefill_B1_S300_16x16_hd128": (1, 300, 16, 16, 128, True, None),
    "encdec_prefill_B1_S300_16x16_hd64_noncausal": (1, 300, 16, 16, 64, False, None),
    "llama_prefill_B1_S300_32x8_hd64": (1, 300, 32, 8, 64, True, None),
    "pipeline_B1_S1024_32x8_hd64": (1, 1024, 32, 8, 64, True, None),
    "dist_B2_S1024_16x4_hd64": (2, 1024, 16, 4, 64, True, None),
    "moe_dist_B2_S1024_8x8_hd128": (2, 1024, 8, 8, 128, True, None),
    "sharded_B2_S512_16x4_hd64": (2, 512, 16, 4, 64, True, None),
    "hybrid_prefill_B1_S2560_16x1_hd256_w2048": (1, 2560, 16, 1, 256, True, 2048),
    "hybrid_train_B1_S4096_16x1_hd256_w2048": (1, 4096, 16, 1, 256, True, 2048),
    # no main path runs hd 32; this row decides which instance serves it
    "hd32_B4_S1024_32x8": (4, 1024, 32, 8, 32, True, None),
}
RMSNORM_FWD_CASES = {  # name: (N, D), bf16
    "rmsnorm_fwd_512x2048": (512, 2048),
    "rmsnorm_fwd_300x2048": (300, 2048),
    "rmsnorm_fwd_4x2048": (4, 2048),
    "rmsnorm_fwd_16384x64": (16384, 64),
    "rmsnorm_fwd_4096x2048": (4096, 2048),
    "rmsnorm_fwd_4096x4096": (4096, 4096),
    "rmsnorm_fwd_131072x64": (131072, 64),
    "rmsnorm_fwd_2560x4096": (2560, 4096),
    "rmsnorm_fwd_4x4096": (4, 4096),
    "rmsnorm_fwd_768x6144": (768, 6144),
    "rmsnorm_fwd_556x6144": (556, 6144),
    "rmsnorm_fwd_4x6144": (4, 6144),
    "rmsnorm_fwd_5120x6144": (5120, 6144),
    "rmsnorm_fwd_512x1024": (512, 1024),
    "rmsnorm_fwd_300x1024": (300, 1024),
    "rmsnorm_fwd_4x1024": (4, 1024),
    "rmsnorm_fwd_4096x1024": (4096, 1024),
}
RGLRU_CASES = {  # name: (B, S, D, dtype name), with h0
    "rglru_1x2560x4096_f32": (1, 2560, 4096, "float32"),
    "rglru_1x2560x4096_bf16": (1, 2560, 4096, "bfloat16"),
    "rglru_1x512x4096_f32": (1, 512, 4096, "float32"),
}
WKV6_CASES = {  # name: (B, S, H, K): bf16 r/k/v, f32 w, u and state
    "wkv6_1x512x32x64_bf16": (1, 512, 32, 64),
    "wkv6_1x300x32x64_bf16": (1, 300, 32, 64),
}
RMSNORM_BWD_CASES = {  # name: (N, D, dtype name)
    "rmsnorm_bwd_4096x2048_bf16": (4096, 2048, "bfloat16"),
    "rmsnorm_bwd_300x2048_bf16": (300, 2048, "bfloat16"),
    "rmsnorm_bwd_16384x64_bf16": (16384, 64, "bfloat16"),
    "rmsnorm_bwd_7x100_f32": (7, 100, "float32"),
}


def _host_us(torch, fn, reps: int = 7, inner: int = 50) -> float:
    """Median over ``reps`` host-clock windows of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / inner)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def _kernel_us(torch, fn, calls: int = 20) -> list[tuple[str, float]]:
    """(kernel, device microseconds a call) of what ``fn`` launches, over
    ``calls`` back-to-back calls under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    def short(key: str) -> str:  # "void (anonymous namespace)::wkv6_out_kernel<...>(...)"
        found = re.search(r"(\w+_kernel)(<[^()]*>)?", key)
        return found.group(0) if found else key[:48]

    return [(short(e.key), e.self_device_time_total / calls)
            for e in sorted(events, key=lambda e: -e.self_device_time_total)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1],
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--profile", action="store_true",
                        help="also break each recurrence call's device time down by kernel")
    parser.add_argument("--dkv-splits", action="store_true",
                        help="also time the dkv path cases at every split of the group")
    parser.add_argument("--check", action="store_true",
                        help="hold each forward path case against its plain version first")
    parser.add_argument("--only", default="",
                        help="time only the cases whose key matches this regular expression")
    args = parser.parse_args()
    want = re.compile(args.only).search

    import torch

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import _device_ms  # this checkout's timer, whichever package is timed

    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rwkv6 import ops as wk_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    build_s = build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planner = fa_ops.dkv_split

    def sweep(name, dkv, b, s, kv, group, hd):
        """``name``'s dkv call at every split of the group, and the plan's."""
        chosen = planner(b, s, kv, group, hd, sms)
        for split in (d for d in range(1, group + 1) if group % d == 0):
            fa_ops.dkv_split = lambda *_, split=split: split
            times[f"dkv_{name}_split{split}"] = _device_ms(torch, dkv)
        fa_ops.dkv_split = planner
        times[f"dkv_{name}_planner_split"] = chosen

    times, plans = {}, {}
    for name, (b, s, window) in BWD_CASES.items():
        if not want(f"dq_{name}_hd64") and not want(f"dkv_{name}_hd64"):
            continue
        q, do = rnd(b, s, 32, 64), rnd(b, s, 32, 64)
        k, v = rnd(b, s, 8, 64), rnd(b, s, 8, 64)
        out, lse = fa_ops.flash_fwd_plain(q, k, v, causal=True, window=window)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        grads_of = (q, k, v, do, lse, delta)
        times[f"dq_{name}_hd64"] = _device_ms(
            torch, lambda: fa_ops.flash_bwd_dq(*grads_of, causal=True, window=window))
        times[f"dkv_{name}_hd64"] = _device_ms(
            torch, lambda: fa_ops.flash_bwd_dkv(*grads_of, causal=True, window=window))
    profiled = {}
    for name, (b, s, window) in HD256_BWD_CASES.items():
        if not want(f"dq_{name}_hd256") and not want(f"dkv_{name}_hd256"):
            continue
        q, do = rnd(b, s, 16, 256), rnd(b, s, 16, 256)
        k, v = rnd(b, s, 1, 256), rnd(b, s, 1, 256)
        out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=window)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        grads_of = (q, k, v, do, lse, delta)
        times[f"dq_{name}_hd256"] = _device_ms(
            torch, lambda: fa_ops.flash_bwd_dq(*grads_of, causal=True, window=window))
        dkv = (lambda grads_of=grads_of, window=window:
               fa_ops.flash_bwd_dkv(*grads_of, causal=True, window=window))
        times[f"dkv_{name}_hd256"] = _device_ms(torch, dkv)
        profiled[f"dkv_{name}_hd256"] = dkv
        if args.dkv_splits:
            sweep(f"{name}_hd256", dkv, b, s, 1, 16, 256)
    for name, (b, s, h, kv, hd, causal) in DKV_PATH_CASES.items():
        if not want(f"dkv_{name}"):
            continue
        q, do = rnd(b, s, h, hd), rnd(b, s, h, hd)
        k, v = rnd(b, s, kv, hd), rnd(b, s, kv, hd)
        out, lse = fa_ops.flash_fwd(q, k, v, causal=causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dkv = (lambda grads_of=(q, k, v, do, lse, delta), causal=causal:
               fa_ops.flash_bwd_dkv(*grads_of, causal=causal))
        times[f"dkv_{name}"] = _device_ms(torch, dkv)
        if hasattr(fa_ops, "dkv_plan"):
            plans[name] = fa_ops.dkv_plan(b, s, kv, h // kv, hd, torch.bfloat16, sms)
        if args.dkv_splits:
            sweep(name, dkv, b, s, kv, h // kv, hd)
    for name, (b, s, h, kv, hd, causal, window) in FWD_PATH_CASES.items():
        if not want(f"fwd_{name}"):
            continue
        q, k, v = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
        if args.check:
            out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
            ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
            del out, lse, ref_out, ref_lse
        times[f"fwd_{name}"] = _device_ms(
            torch, lambda: fa_ops.flash_fwd(q, k, v, causal=causal, window=window))
    for name, (n, d) in RMSNORM_FWD_CASES.items():
        if not want(name):
            continue
        x = rnd(n, d)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(torch.bfloat16)
        times[name] = _device_ms(torch, lambda: rn_ops.rms_norm_fwd(x, w, 1e-5))
    for name, (n, d, dtype) in RMSNORM_BWD_CASES.items():
        if not want(name):
            continue
        dtype = getattr(torch, dtype)
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
        dy = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        times[name] = _device_ms(torch, lambda: rn_ops.rms_norm_bwd(x, w, dy, 1e-5))
    recurrences = {}
    for name, (b, s, d, dtype) in RGLRU_CASES.items():
        dtype = getattr(torch, dtype)
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device="cuda")).to(dtype)
        x = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
        h0 = torch.randn((b, d), generator=gen, device="cuda")
        recurrences[name] = lambda a=a, x=x, h0=h0: rg_ops.rglru_fwd(a, x, h0)
    for name, (b, s, h, k) in WKV6_CASES.items():
        r, kk, v = (rnd(b, s, h, k) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((b, s, h, k), generator=gen, device="cuda")))
        u = 0.5 * torch.randn((h, k), generator=gen, device="cuda")
        state = torch.randn((b, h, k, k), generator=gen, device="cuda")
        recurrences[name] = (lambda r=r, kk=kk, v=v, w=w, u=u, state=state:
                             wk_ops.wkv6_fwd(r, kk, v, w, u, state))
    recurrences = {name: fn for name, fn in recurrences.items() if want(name)}
    for name, fn in recurrences.items():
        times[name] = _device_ms(torch, fn)
    if args.profile:
        for name, fn in {**profiled, **recurrences}.items():
            print(f"[profile] {name}: " + ", ".join(
                f"{kernel} {us:.3f} us" for kernel, us in _kernel_us(torch, fn)), flush=True)
    # host microseconds of a forward call at the serving shape: the wrapper
    # (checks, outputs, strides, launch) and its C entry point alone (tensor
    # maps and launch), in windows short enough that the launch queue never
    # fills, so the device's pace stays out of them
    q, k, v = rnd(1, 512, 32, 64), rnd(1, 512, 8, 64), rnd(1, 512, 8, 64)
    out, lse = fa_ops.flash_fwd(q, k, v, causal=True)
    strides = [n for x in (q, k, v) for n in x.stride()[:3]]
    if hasattr(fa_ops, "tma_strides"):  # checkouts whose bf16 kernels read q, k, v by TMA
        strides = [n for x in (q, k, v)
                   for n in fa_ops.tma_strides(x.shape, x.stride(), x.dtype, x.data_ptr())]
    entry = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), 1,
             1, 512, 512, 32, 8, 64, *strides, *out.stride()[:3], 1, 0, 64 ** -0.5,
             torch.cuda.current_stream().cuda_stream]
    host = {"wrapper": lambda: fa_ops.flash_fwd(q, k, v, causal=True),
            "entry_point": lambda: fa_ops._fwd_kernel()(*entry)}
    host_us = {name: _host_us(torch, fn) for name, fn in host.items()}
    # registers, local bytes, shared memory and threads of each bf16 forward
    # instance that ran
    fwd_info = {hd: fa_ops.kernel_info("flash_fwd", torch.bfloat16, hd)
                for hd in sorted({c[4] for n, c in FWD_PATH_CASES.items() if f"fwd_{n}" in times})}
    print(json.dumps({"root": str(args.root), "build_s": round(build_s, 2),
                      "device": torch.cuda.get_device_name(0), "ms": times,
                      "dkv_plans": plans, "fwd_instances": fwd_info,
                      "fwd_serve_host_us": host_us}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
