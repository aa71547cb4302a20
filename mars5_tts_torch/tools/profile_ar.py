"""Where the time of AR decoding goes, on one GPU.

    python3 mars5_tts_torch/tools/profile_ar.py [--engine fused4|fused4-head4|fused|bf16]
        [--rows 1] [--tokens 200] [--repeat 5] [--root DIR] [--device cuda]

Builds the released-width AR (26 x 1536, 24,000 ids) with random weights
from a seed, packs it for the quantized engines (``prepare_fused``), and
generates ``--tokens`` tokens in each of ``--rows`` rows (600-token prompts
of their own; more than one row runs the batched engine) with a 525-frame
speaker reference (the EOS id lies outside the
sampling window, so every run has the same length): once to warm up,
``--repeat`` times timed, once under ``torch.profiler``, once timed again.
Prints one JSON line: the wall ms a decode step (each timed run, their
median, and the run after the profiler has traced the process), the device
busy ms a step (the device's own events: kernels, copies, fills) and the idle
share, the kernel launches a step (``cudaLaunchKernel``,
``cudaLaunchCooperativeKernel``, ``cudaLaunchKernelExC``), the host-to-device
copies and stream waits a step, the host ops with the most self CPU time a
step, and, for the quantized engines, K2's own kernels: their launches and
device ms a step in the generation, and the device ms and launches of one
K2 call at position 600 (rows at 600, 700, ...).

``--root`` imports ``mars5_tts_torch`` from another checkout, so two
versions (a parent commit's and a change's) run the same measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

# K2's kernels, by name: the persistent step and the launch sequence it replaced
K2_KERNEL = re.compile(r"\b(fused_decode_step|gemv_kernel|attention_kernel|load_x_kernel)\b")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC")


def device_events(events):
    """The device's own events of ``key_averages()`` (kernels, copies, fills):
    a host op's device time repeats its kernels', and a user annotation's
    spans them, so neither counts."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]


def device_us(events) -> float:
    """Device busy microseconds: each device event counted once."""
    return sum(e.self_device_time_total for e in device_events(events))


def k2_kernels(events) -> tuple[float, int]:
    """(device us, launches) of K2's own kernels among ``events``."""
    k2 = [e for e in device_events(events) if K2_KERNEL.search(e.key)]
    return sum(e.self_device_time_total for e in k2), sum(e.count for e in k2)


def launches(events) -> int:
    """Kernel launches made by the host: the CUDA runtime's launch calls."""
    return sum(e.count for e in events if e.key in LAUNCH_CALLS)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="fused4",
                    choices=("fused4", "fused4-head4", "fused", "bf16"))
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--tokens", type=int, default=200)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate_batched
    from mars5_tts_torch.models.ar_decode_fused import (FusedCache, ar_generate_fused_batched,
                                                        prepare_fused)
    from mars5_tts_torch.ops.kernels.decode_layer import fused_decode_layers

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("profile_ar: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card

    def sync():
        if on_card:
            torch.cuda.synchronize()

    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(CodecLMConfig.mars5(24_000)).init_(g).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    n_text, n_speech = 258, 1025                 # the smoke's tokenizers' ids
    prompts = [rng.integers(0, n_text + n_speech - 1, 600) for _ in range(args.rows)]
    spks = [rng.integers(0, 1024, (525, 8)) for _ in range(args.rows)]
    eos = n_text + n_speech - 1
    s = ArSampling(n_phones_gen=100, eos_idx=eos, valid_start=n_text, valid_end=eos,
                   max_len=600 + args.tokens)

    fp = dims = None
    if args.engine == "bf16":
        def run():
            return ar_generate_batched(ar, prompts, spks, sampling=s, seed=1)
    else:
        fp, dims = prepare_fused(ar, s.max_len, 8 if args.engine == "fused" else 4,
                                 head4=args.engine == "fused4-head4", batch=args.rows)

        def run():
            return ar_generate_fused_batched(ar, fp, dims, prompts, spks, sampling=s, seed=1)

    run()
    sync()
    walls = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        n_gen = max(n for _, n in run())     # decode steps: every row runs every step
        sync()
        walls.append((time.perf_counter() - t0) * 1e3 / n_gen)
    wall_ms = float(np.median(walls))
    with profile(activities=activities) as prof:
        run()
        sync()
    t0 = time.perf_counter()
    run()
    sync()
    after_ms = (time.perf_counter() - t0) * 1e3 / n_gen
    events = prof.key_averages()
    busy_ms = device_us(events) / 1e3 / n_gen
    by_name = {e.key: e for e in events if e.device_type == DeviceType.CPU}

    def calls(name):
        return by_name[name].count / n_gen if name in by_name else 0.0
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    out = {"engine": args.engine, "rows": args.rows, "root": os.path.abspath(args.root),
           "tokens": n_gen, "wall_ms_per_token": wall_ms, "wall_ms_per_token_runs": walls,
           "wall_ms_per_token_after_profiler": after_ms,
           "device_ms_per_token": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
           "memcpy_calls_per_token": calls("cudaMemcpyAsync"),
           "stream_syncs_per_token": calls("cudaStreamSynchronize"),
           "launches_per_token": launches(events) / n_gen,
           "top_host_ops_us_per_token": {e.key: round(e.self_cpu_time_total / n_gen, 1)
                                         for e in host}}
    if fp is not None:
        k2_us, k2_n = k2_kernels(events)
        out["k2_launches_per_token"] = k2_n / n_gen
        out["k2_device_ms_per_token"] = k2_us / 1e3 / n_gen
        cache = FusedCache(dims, dev, args.rows)
        x = fp["embed"][:args.rows].to(torch.bfloat16)
        pos = [600 + 100 * r for r in range(args.rows)]

        def k2():
            return fused_decode_layers(fp, x, pos, cache.k, cache.v, cache.scales, dims=dims,
                                       norm_eps=ar.cfg.norm_eps)
        k2()
        sync()
        with profile(activities=activities) as p2:
            for _ in range(20):
                k2()
            sync()
        k2_us, k2_n = k2_kernels(p2.key_averages())
        out["k2_device_ms"] = k2_us / 20 / 1e3
        out["k2_launches_per_call"] = k2_n / 20
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
