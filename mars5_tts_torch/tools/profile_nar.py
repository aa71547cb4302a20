"""Where the time of the NAR diffusion goes, on one GPU.

    python3 mars5_tts_torch/tools/profile_nar.py [--nar int8|bf16] [--mega]
        [--prompt 525] [--gen 200] [--steps 200] [--repeat 3] [--profile-steps 20]
        [--root DIR] [--device cuda]

Builds the released-width NAR (8 + 16 x 1024 layers, 4,096 text ids) with
random weights from a seed, quantized with ``quantize_nar`` for ``int8``,
and runs a deep-clone diffusion as ``Mars5TTS.tts`` does: 66 text tokens, a
``--prompt``-frame reference, ``--gen`` generated frames (the defaults are
the smoke request's 525 + 200 frames; 450 + 750 is the bench geometry), CFG
w = 3, ``--steps`` reverse steps on the generator path: once to warm up,
``--repeat`` times timed, then a ``--profile-steps`` run under
``torch.profiler`` (a step does the same work at any T, and the profiler's
own cost grows with the ops it records). Prints one JSON
line: the wall ms a step (each timed run and their median), the device busy
ms a step (the device's own events: kernels, copies, fills) and the idle
share, the device ms a step of the self-attention kernel K1 (``mha_fwd``)
and of the W8A8 sites K3 ``fused_linear`` and K4 ``fused_ffn`` (the device
spans of the profiler ranges ``mark_w8a8_sites`` puts around the decoder's
calls for the profiled run only), the ``w8a8_*`` kernels' device ms a step
and each one's device us a launch, the kernel launches and stream waits a
step, and the host ops with the most self CPU time a step.

``--mega`` (int8 only) runs the decoder stack through kernel K9 (the
``nar_mega=True`` route: the stack's ``build_mega_pack``, built before the
warm-up) and adds K9's device ms a step (the device spans of the profiler
range ``mark_mega`` puts around each call) and the device ms a step of every
kernel outside those spans, by name.

``--root`` imports ``mars5_tts_torch`` from another checkout, so two
versions (a parent commit's and a change's) run the same measurement.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys
import time

SITES = {"fused_linear": "w8a8_k3", "fused_ffn": "w8a8_k4"}   # wrapper -> profiler range
MEGA = "mega_k9"                                               # K9's profiler range


def mark_w8a8_sites(layers) -> None:
    """Wraps the decoder layer's K3 and K4 calls (``layers.fused_linear``,
    ``layers.fused_ffn``) in profiler ranges named by ``SITES``, so that the
    device work each call launches is read per site, for this checkout's
    wrappers and for another's alike."""
    from torch.profiler import record_function

    for name, label in SITES.items():
        fn = getattr(layers, name)

        @functools.wraps(fn)
        def ranged(*args, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*args, **kw)
        setattr(layers, name, ranged)


def mark_mega(layers) -> None:
    """Wraps the decoder stack's K9 calls (``layers.mega_decoder_stack``) in
    the profiler range ``MEGA``."""
    from torch.profiler import record_function

    fn = layers.mega_decoder_stack

    @functools.wraps(fn)
    def ranged(*args, **kw):
        with record_function(MEGA):
            return fn(*args, **kw)
    layers.mega_decoder_stack = ranged


def outside_spans(kernels, spans) -> dict:
    """Device us by name of the ``kernels`` ((name, start, end) in us) that
    start outside every (start, end) of ``spans``."""
    spans = sorted(spans)
    out: dict = {}
    for name, t0, t1 in kernels:
        if not any(a <= t0 < b for a, b in spans):
            out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument list
    (template arguments kept)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):                  # cut the argument list
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    depth, cut = 0, 0
    for i, ch in enumerate(name):          # the last top-level namespace separator
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if depth == 0 and name.startswith("::", i):
            cut = i + 2
    return name[cut:].strip() or name


def w8a8_label(name: str):
    """A W8A8 kernel's name without its namespace and arguments (e.g.
    ``w8a8_wgmma_gemm<256>``), or None for any other kernel."""
    m = re.search(r"\bw8a8_\w+(?:<[^>]*>)?", name)
    return m.group(0) if m else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nar", default="int8", choices=("int8", "bf16"))
    ap.add_argument("--mega", action="store_true", help="the decoder stack through K9")
    ap.add_argument("--prompt", type=int, default=525)
    ap.add_argument("--gen", type=int, default=200)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--profile-steps", type=int, default=20)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = ap.parse_args()
    if args.mega and args.nar != "int8":
        ap.error("--mega needs --nar int8")
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels.nar_mega import build_mega_pack
    from mars5_tts_torch.ops.quant import quantize_nar

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("profile_nar: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card

    def sync():
        if on_card:
            torch.cuda.synchronize()

    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        nar = ResidualTransformer(ResidualTransformerConfig.mars5(4_096)).init_(g)
        nar = nar.to(torch.bfloat16).eval()
    if args.nar == "int8":
        nar = quantize_nar(nar)
    mega = build_mega_pack(nar.tfm.decoder) if args.mega else None
    rng = np.random.default_rng(0)
    text = rng.integers(0, nar.cfg.n_text_vocab, (1, 66))
    c_codes = rng.integers(0, 1024, (1, args.prompt, 8))
    x = np.repeat(rng.integers(0, 1024, (1, args.prompt + args.gen, 1)), 8, axis=2)
    batch = (text, c_codes, np.asarray([66]), np.asarray([args.prompt]), x,
             np.zeros((1, x.shape[1]), bool))
    cfg = InferenceConfig()
    dsh = DSH(last_greedy=True, x_0_temp=cfg.x_0_temp, guidance_w=cfg.nar_guidance_w,
              deep_clone=True, jump_len=1, jump_n_sample=1,
              q0_override_steps=cfg.q0_override_steps, enable_kevin_scaled_inference=True,
              progress=False)
    steps, p_steps = args.steps, args.profile_steps

    def run(t):
        gen = torch.Generator(device=dev).manual_seed(1)
        diff = MultinomialDiffusion(1025, timesteps=t, device=dev)
        return perform_simple_inference(nar, batch, diff, t, dsh, retain_quant0=True,
                                        generator=gen, mega=mega)

    with torch.no_grad():
        run(steps)
        sync()
        walls = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            run(steps)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3 / steps)
        mark_w8a8_sites(layers)
        mark_mega(layers)
        run(p_steps)
        sync()
        with profile(activities=activities) as prof:
            run(p_steps)
            sync()
    wall_ms = float(np.median(walls))
    events = prof.key_averages()
    # a host op's device time repeats its kernels': count the device's own events
    device = [e for e in events if e.device_type != DeviceType.CPU]
    kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    k1_us = sum(e.self_device_time_total for e in kernels if "mha_fwd" in e.key)
    # a site's: the device spans of its profiler ranges (first kernel's start
    # to last kernel's end in each call), beside the W8A8 kernels' own sum
    site_us = {label: sum(e.device_time_total for e in device if e.key == label)
               for label in SITES.values()}
    w8a8 = [e for e in kernels if w8a8_label(e.key) and e.count]
    by_name = {e.key: e for e in events if e.device_type == DeviceType.CPU}

    def calls(name):
        return by_name[name].count / p_steps if name in by_name else 0.0
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    out = {"nar": args.nar, "root": os.path.abspath(args.root),
           "frames": args.prompt + args.gen, "steps": steps, "profile_steps": p_steps,
           "wall_ms_per_step": wall_ms, "wall_ms_per_step_runs": walls,
           "device_ms_per_step": device_us / 1e3 / p_steps,
           "device_idle_share": 1 - device_us / 1e3 / p_steps / wall_ms,
           "k1_device_ms_per_step": k1_us / 1e3 / p_steps,
           "k3_device_ms_per_step": site_us["w8a8_k3"] / 1e3 / p_steps,
           "k4_device_ms_per_step": site_us["w8a8_k4"] / 1e3 / p_steps,
           "w8a8_kernels_device_ms_per_step":
               sum(e.self_device_time_total for e in w8a8) / 1e3 / p_steps,
           "w8a8_kernel_us_per_launch": {
               w8a8_label(e.key): round(e.self_device_time_total / e.count, 1) for e in w8a8},
           "launches_per_step": calls("cudaLaunchKernel") + calls("cudaLaunchKernelExC"),
           "stream_syncs_per_step": calls("cudaStreamSynchronize"),
           "top_host_ops_us_per_step": {e.key: round(e.self_cpu_time_total / p_steps, 1)
                                        for e in host}}
    if args.mega:
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name == MEGA and e.device_type != DeviceType.CPU]
        kern = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type != DeviceType.CPU and e.name != MEGA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in SITES.values()]
        outside = outside_spans(kern, spans)
        out["mega"] = True
        out["k9_device_ms_per_step"] = sum(b - a for a, b in spans) / 1e3 / p_steps
        out["k9_calls_per_step"] = len(spans) / p_steps
        out["outside_k9_device_ms_per_step"] = sum(outside.values()) / 1e3 / p_steps
        by_name: dict = {}
        for name, us in outside.items():
            by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + us
        out["outside_k9_device_ms_per_step_by_kernel"] = {
            k: round(v / 1e3 / p_steps, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
