"""Where the time of one-row AR decoding goes, on one GPU.

    python3 mars5_tts_torch/tools/profile_ar.py [--engine fused4|fused4-head4|fused|bf16]
        [--tokens 200] [--repeat 5] [--root DIR] [--device cuda]

Builds the released-width AR (26 x 1536, 24,000 ids) with random weights
from a seed, packs it for the quantized engines (``prepare_fused``), and
generates ``--tokens`` tokens after a 600-token prompt with a 525-frame
speaker reference (the EOS id lies outside the sampling window, so every run
has the same length): once to warm up, ``--repeat`` times timed, once
under ``torch.profiler``, once timed again. Prints one JSON line: the wall
ms a token (each timed run, their median, and the run after the profiler
has traced the process), the device
busy ms a token (kernel and copy time over the run) and the idle share, the
host-to-device copies and stream waits a token, the host ops with the most
self CPU time a token, and, for the quantized engines, the device time of
one K2 call at position 600.

``--root`` imports ``mars5_tts_torch`` from another checkout, so two
versions (a parent commit's and a change's) run the same measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="fused4",
                    choices=("fused4", "fused4-head4", "fused", "bf16"))
    ap.add_argument("--tokens", type=int, default=200)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import (FusedCache, ar_generate_fused,
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
    prompt = rng.integers(0, n_text + n_speech - 1, 600)
    spk = rng.integers(0, 1024, (525, 8))
    eos = n_text + n_speech - 1
    s = ArSampling(n_phones_gen=100, eos_idx=eos, valid_start=n_text, valid_end=eos,
                   max_len=len(prompt) + args.tokens)

    fp = dims = None
    if args.engine == "bf16":
        def run():
            return ar_generate(ar, prompt, spk, sampling=s, seed=1)
    else:
        fp, dims = prepare_fused(ar, s.max_len, 8 if args.engine == "fused" else 4,
                                 head4=args.engine == "fused4-head4")

        def run():
            return ar_generate_fused(ar, fp, dims, prompt, spk, sampling=s, seed=1)

    run()
    sync()
    walls = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        _, n_gen = run()
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
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    by_name = {e.key: e for e in events}

    def calls(name):
        return by_name[name].count / n_gen if name in by_name else 0.0
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    out = {"engine": args.engine, "root": os.path.abspath(args.root), "tokens": n_gen,
           "wall_ms_per_token": wall_ms, "wall_ms_per_token_runs": walls,
           "wall_ms_per_token_after_profiler": after_ms,
           "device_ms_per_token": device_us / 1e3 / n_gen,
           "device_idle_share": 1 - device_us / 1e3 / n_gen / wall_ms,
           "memcpy_calls_per_token": calls("cudaMemcpyAsync"),
           "stream_syncs_per_token": calls("cudaStreamSynchronize"),
           "launches_per_token": calls("cudaLaunchKernel"),
           "top_host_ops_us_per_token": {e.key: round(e.self_cpu_time_total / n_gen, 1)
                                         for e in host}}
    if fp is not None:
        cache = FusedCache(dims, dev)
        x = fp["embed"][:1].to(torch.bfloat16)

        def k2():
            return fused_decode_layers(fp, x, 600, cache.k, cache.v, cache.scales, dims=dims,
                                       norm_eps=ar.cfg.norm_eps)
        k2()
        sync()
        with profile(activities=activities) as p2:
            for _ in range(20):
                k2()
            sync()
        us = sum(getattr(e, "self_device_time_total", 0) for e in p2.key_averages())
        out["k2_device_ms"] = us / 20 / 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
