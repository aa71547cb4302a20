#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``mars5_tts_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compiles the three CUDA libraries from ``mars5_tts_torch/csrc`` for
   sm_90a into ``build/kernels/``, one nvcc each, all at once.
3. Kernels against their plain PyTorch twins on the card, at the main paths'
   shapes, with stated error bounds and CUDA-event timings: K1 attention,
   K3 fused_linear (qkv, caq and residual variants), K4 fused_ffn, K6
   heads_diffusion_tail (w = 3, at t = 0 and a middle t).
4. Main paths: ``Mars5TTS`` at the released widths (AR 26 x 1536, NAR 8 + 16 x
   1024, Encodec, Vocos) with seeded random weights and a bf16 AR, serving
   deep-clone ``tts()`` requests with 7 s references (525 prompt frames, so
   the NAR self-attention runs kernel K1), 200 diffusion steps, CFG w = 3:
   one request with the bf16 NAR, then two (the first a warm-up) with
   ``nar_backend="int8"``, whose every reverse step runs K1, K3, K4 and K6.
   Each path's launch counts are reset before it and read after it.

Prints one JSON line with the kernels' results, then as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing a result.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

MAIN_SHAPE = (2, 1200, 16, 64)     # NAR self-attention: CFG rows, frames, heads, head dim
SECOND_SHAPE = (2, 525, 16, 64)
REF_SECONDS = 7.0
GEN_FRAMES = 200                    # AR cap per request, ~2.7 s of audio
STEPS = 200
# W8A8 kernels at the bench geometry (bench.py:47-49): M = 2 CFG rows x 1200
# frames, 750 generated frames, model dim 1024, FFN 3072, 7 lanes x 1025
M_ROWS, DIM, FFN = 2400, 1024, 3072
GEN_LEN, LANES, CLASSES = 750, 7, 1025
LIBS = {"mha": ("mha.cu",), "nar_fused": ("nar_fused.cu",),
        "diffusion_tail": ("diffusion_tail.cu",)}


def cuda_ms(fn, n=30, warmup=5):
    """Median milliseconds of ``fn`` over ``n`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(K, shape, masked, dtype, gen, dev):
    import torch
    b, l, h, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    mask = None
    if masked:
        mask = torch.zeros((b, l), dtype=torch.bool, device=dev)
        mask[-1, l - l // 6:] = True          # pad the tail of the last row
    out = K.mha(q, k, v, mask)
    ref = K.mha_ref(q, k, v, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"K1 {shape}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        bound = K.bf16_row_bound(ref)
        bound_txt = "2 bf16 ulp of each row's peak"
    else:
        bound = torch.full_like(diff, 1e-5) * ref.float().abs().max().clamp_min(1.0)
        bound_txt = "1e-5 x max(1, peak)"
    ok = bool((diff <= bound).all())
    res = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "ms": cuda_ms(lambda: K.mha(q, k, v, mask)),
           "plain_ms": cuda_ms(lambda: K.mha_ref(q, k, v, mask))}
    print(f"K1 {tuple(shape)} {str(dtype).split('.')[-1]} mask={masked}: "
          f"max_abs_err={res['max_abs_err']:.3e} mean_abs_err={res['mean_abs_err']:.3e} "
          f"bound={bound_txt} (max {bound.max().item():.3e}) within={ok} | "
          f"kernel {res['ms'] * 1e3:.1f} us, plain {res['plain_ms'] * 1e3:.1f} us",
          flush=True)
    if not ok:
        raise RuntimeError(f"K1 {shape}: error above its bound")
    return res


def fused_bound(got, want):
    """The JAX kernel tests' own bound (tests/test_nar_fused.py
    _assert_fused_eq): |diff| <= 0.02 x max(peak, 1), more than 95% of the
    elements exactly equal, mean |diff| < 2e-3 x max(peak, 1)."""
    import torch
    g, w = got.float(), want.float()
    peak = max(w.abs().max().item(), 1.0)
    diff = (g - w).abs()
    stats = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
             "exact_frac": (g == w).float().mean().item()}
    ok = (stats["max_abs_err"] <= 0.02 * peak and stats["exact_frac"] > 0.95
          and stats["mean_abs_err"] < 2e-3 * peak and bool(torch.isfinite(g).all()))
    return ok, stats


def rand_qweight(n, k, gen, dev):
    import torch
    from mars5_tts_torch.ops.quant import quantize_weight
    return quantize_weight(torch.randn((n, k), generator=gen, device=dev) * 0.03)


def check_w8a8(name, run, twin):
    """One K3/K4 variant against its twin, with CUDA-event times."""
    import torch
    out = run()
    ref = twin()
    torch.cuda.synchronize()
    ok, st = fused_bound(out, ref)
    st.update(ms=cuda_ms(run), plain_ms=cuda_ms(twin))
    print(f"{name}: max_abs_err={st['max_abs_err']:.3e} mean_abs_err={st['mean_abs_err']:.3e} "
          f"exact={st['exact_frac']:.4f} bound=fused_eq(0.02 peak, >95% exact, mean<2e-3 peak) "
          f"within={ok} | kernel {st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} us",
          flush=True)
    if not ok:
        raise RuntimeError(f"{name}: error above its bound")
    return st


def check_nar_fused(gen, dev):
    """K3 (qkv with LN + bias, caq, residual) and K4 at the decoder's shapes."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F

    x = torch.randn((2, M_ROWS // 2, DIM), generator=gen, device=dev).to(torch.bfloat16)
    ln = (1 + 0.1 * torch.randn(DIM, generator=gen, device=dev),
          0.1 * torch.randn(DIM, generator=gen, device=dev))
    qkv_w = rand_qweight(3 * DIM, DIM, gen, dev)
    qkv_b = 0.1 * torch.randn(3 * DIM, generator=gen, device=dev)
    sq_w = rand_qweight(DIM, DIM, gen, dev)
    sq_b = 0.1 * torch.randn(DIM, generator=gen, device=dev)
    res = {}
    res["qkv"] = check_w8a8(
        "K3 qkv (2, 1200, 1024) -> 3072, LN + bias",
        lambda: F.fused_linear(x, qkv_w, ln=ln, bias=qkv_b),
        lambda: F.fused_linear_ref(x, qkv_w, ln=ln, bias=qkv_b))
    res["caq"] = check_w8a8(
        "K3 caq (2, 1200, 1024) -> 1024, LN + bias",
        lambda: F.fused_linear(x, sq_w, ln=ln, bias=sq_b),
        lambda: F.fused_linear_ref(x, sq_w, ln=ln, bias=sq_b))
    a = (x * 0.5).contiguous()
    res["residual"] = check_w8a8(
        "K3 residual (2, 1200, 1024) -> 1024, bias + residual",
        lambda: F.fused_linear(a, sq_w, bias=sq_b, residual=x),
        lambda: F.fused_linear_ref(a, sq_w, bias=sq_b, residual=x))
    w, v = rand_qweight(FFN, DIM, gen, dev), rand_qweight(FFN, DIM, gen, dev)
    l2 = rand_qweight(DIM, FFN, gen, dev)
    l2_b = 0.1 * torch.randn(DIM, generator=gen, device=dev)
    res["ffn"] = check_w8a8(
        "K4 ffn (2, 1200, 1024), F 3072",
        lambda: F.fused_ffn(x, ln, w, v, l2, l2_b),
        lambda: F.fused_ffn_ref(x, ln, w, v, l2, l2_b))
    return res


def check_heads_tail(gen, dev):
    """K6 at the bench shape, w = 3, at t = 0 and a middle t: indices equal to
    the twin's except where the twin's two best scores lie within 1e-5.
    ``max_abs_err`` is the largest shortfall of the twin's score at the
    kernel's index below the twin's best score (0 where they agree)."""
    import torch
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    out = torch.randn((2, GEN_LEN, DIM), generator=gen, device=dev).to(torch.bfloat16)
    x8, xs = nar_heads_prequant(out)
    wf = torch.randn((LANES, CLASSES, DIM), generator=gen, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((LANES, CLASSES), generator=gen, device=dev)}
    diff = MultinomialDiffusion(CLASSES, timesteps=STEPS, device=dev)
    x_t = torch.randint(0, CLASSES, (1, GEN_LEN, LANES), generator=gen, device=dev)
    res = []
    for t in (0, STEPS // 2):
        u0 = torch.rand((1, GEN_LEN, LANES, CLASSES), generator=gen, device=dev)
        scal = D.tail_scalars(diff, t)
        args = (x8, xs, folded, u0, x_t, scal)
        got = D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
        want = D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)
        scores = D.tail_scores(*args, w=3.0, temp=0.7)
        top2 = torch.topk(scores, 2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) <= 1e-5
        shortfall = top2[..., 0] - scores.gather(-1, got[..., None])[..., 0]
        torch.cuda.synchronize()
        mism = got != want
        bad = int((mism & ~near_tie).sum())
        st = {"mismatches": int(mism.sum()), "near_ties": int(near_tie.sum()),
              "max_abs_err": shortfall.max().item(),
              "ms": cuda_ms(lambda: D.heads_diffusion_tail(*args, w=3.0, temp=0.7)),
              "plain_ms": cuda_ms(lambda: D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7))}
        print(f"K6 heads+tail (2, 750, 1024) x (7, 1025) w=3 t={t}: index mismatches "
              f"{st['mismatches']} of {got.numel()} (twin near-ties within 1e-5: "
              f"{st['near_ties']}, mismatches outside them: {bad}) | kernel "
              f"{st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} us", flush=True)
        if bad or got.min() < 0 or got.max() >= CLASSES:
            raise RuntimeError(f"K6 t={t}: indices differ from the twin outside near-ties")
        res.append(st)
    return res


def build_models(dev, torch):
    """The released widths with seeded random weights: (AR, NAR, Encodec,
    Vocos, text and speech tokenizers)."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.encodec import EncodecConfig, EncodecEncoder
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import Vocos, VocosConfig
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    # byte-level text and merge-free speech tokenizers beside a 24k-vocab AR;
    # ar_vocab_window clamps sampling to their 258 + 1025 ids
    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})

    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(CodecLMConfig.mars5(24_000)).init_(g).to(torch.bfloat16)
        nar = ResidualTransformer(ResidualTransformerConfig.mars5(4_096)).init_(g).to(
            torch.bfloat16)
        enc = EncodecEncoder(EncodecConfig.mars5()).init_(g)
        voc = Vocos(VocosConfig.mars5()).init_(g)
    n_params = sum(p.numel() for m in (ar, nar) for p in m.parameters())
    print(f"models: AR {ar.cfg.n_layers}x{ar.cfg.dim}, NAR {nar.cfg.enc_layers}+"
          f"{nar.cfg.dec_layers}x{nar.cfg.dim}, {n_params / 1e6:.0f}M AR+NAR params (bf16)",
          flush=True)
    return ar, nar, enc, voc, texttok, speechtok


def counts():
    from mars5_tts_torch.ops.kernels import diffusion_tail as D, mha as K, nar_fused as F
    return {"mha": K.launch_count, "fused_linear": F.fused_linear_launches,
            "fused_ffn": F.fused_ffn_launches, "heads_diffusion_tail": D.launch_count}


def reset_counts():
    from mars5_tts_torch.ops.kernels import diffusion_tail as D, mha as K, nar_fused as F
    K.reset_launch_count()
    F.reset_launch_counts()
    D.reset_launch_count()


def serve(tts, label, text, transcript, seed, want):
    """One deep-clone request with the counts at 0 before it; checks the
    audio, the grid and each kernel's launches against ``want`` (name ->
    (low, high))."""
    import numpy as np
    import torch
    from mars5_tts_torch import InferenceConfig

    rng = np.random.default_rng(seed)
    ref = (rng.standard_normal(int(REF_SECONDS * tts.sr)) * 0.1).astype(np.float32)
    n_text = len(tts.texttok.encode("<|startoftext|>" + transcript + " " + text
                                    + "<|endoftext|>", allowed_special="all"))
    cfg = InferenceConfig(generate_max_len_override=n_text + int(REF_SECONDS * 75)
                          + GEN_FRAMES, timesteps=STEPS)
    reset_counts()
    t0 = time.perf_counter()
    codes, audio = tts.tts(text, ref, ref_transcript=transcript, cfg=cfg, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    grid = tts.last_grid
    if not (len(audio) > 0 and np.isfinite(audio).all()):
        raise RuntimeError(f"{label}: tts produced empty or non-finite audio")
    if not (int(grid.min()) >= 0 and int(grid.max()) <= 1024):
        raise RuntimeError(f"{label}: grid codes outside [0, 1024]")
    for name, (lo, hi) in want.items():
        if not lo <= launches[name] <= hi:
            raise RuntimeError(f"{label}: {name} launched {launches[name]} times, "
                               f"expected {lo}..{hi}")
    timing = tts.last_timing
    rec = {"path": label, "wall_s": wall, "ar_frames": int(len(codes)),
           "grid": list(grid.shape), "audio_s": timing["audio_s"], "rtf": timing["rtf"],
           "launches": launches,
           "stages_s": {k: round(v, 4) for k, v in timing["stages_s"].items()}}
    print(f"request {label} seed={seed}: {len(codes)} AR frames, grid {tuple(grid.shape)}, "
          f"audio {timing['audio_s']:.3f} s, total {timing['total_s']:.3f} s, "
          f"RTF {timing['rtf']:.4f}, launches {json.dumps(launches)}; stages "
          + json.dumps(rec["stages_s"]), flush=True)
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")

    # -- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 2. build: one nvcc per library, all started together
    from mars5_tts_torch.ops.kernels import build, mha as K
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:
        libs = dict(zip(LIBS, pool.map(lambda kv: build.build(*kv), LIBS.items())))
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        regs = [ln.strip() for ln in build.build_log.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {lib.name} ({'compiled in %.1f s' % build.build_seconds[name] if name in build.build_seconds else 'already built'}); "
              + " | ".join(regs), flush=True)
    print(f"build: all libraries in {build_s:.1f} s", flush=True)

    # -- 3. kernels against plain, on the card
    gen = torch.Generator(device=dev).manual_seed(1)
    main_res = check_kernel(K, MAIN_SHAPE, True, torch.bfloat16, gen, dev)
    second = check_kernel(K, SECOND_SHAPE, False, torch.bfloat16, gen, dev)
    check_kernel(K, (1, 600, 4, 64), True, torch.float32, gen, dev)
    w8a8 = check_nar_fused(gen, dev)
    k6 = check_heads_tail(gen, dev)

    # -- 4. main paths: bf16 NAR, then the W8A8 NAR (first request warms up)
    from mars5_tts_torch import Mars5TTS
    ar, nar, enc, voc, texttok, speechtok = build_models(dev, torch)
    common = dict(texttok=texttok, speechtok=speechtok, encodec=enc, vocos=voc)
    layers = nar.cfg.dec_layers
    torch.cuda.reset_peak_memory_stats(dev)
    records = [serve(Mars5TTS.from_params(ar, nar, **common), "bf16",
                     "The quick brown fox jumps over the lazy dog.", "A reference voice.", 11,
                     {"mha": (layers * STEPS, 10 ** 9)})]
    peak_bf16 = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    tts8 = Mars5TTS.from_params(ar, nar, nar_backend="int8", **common)
    torch.cuda.synchronize()
    print(f"quantize_nar: {time.perf_counter() - t0:.2f} s", flush=True)
    del nar
    torch.cuda.reset_peak_memory_stats(dev)
    want8 = {"mha": (layers * STEPS, 10 ** 9),
             "fused_linear": (2 * layers * STEPS, 2 * layers * STEPS),
             "fused_ffn": (layers * STEPS, layers * STEPS),
             "heads_diffusion_tail": (STEPS, STEPS)}
    int8_launches = {k: 0 for k in want8}
    for text, transcript, seed in (("Hello from the port of the speech model.",
                                    "Another sample here.", 12),
                                   ("The quick brown fox jumps over the lazy dog.",
                                    "A reference voice.", 11)):
        records.append(serve(tts8, "int8", text, transcript, seed, want8))
        for k in int8_launches:
            int8_launches[k] += records[-1]["launches"][k]
    print(json.dumps({"requests": records}), flush=True)
    print(f"peak device memory: bf16 path {peak_bf16 / 2**30:.2f} GiB, int8 path "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise RuntimeError("the port pulled in jax")

    def row(name, source, replaces, st):
        return {"name": name, "route": "cuda", "source": f"mars5_tts_torch/csrc/{source}",
                "replaces": replaces, "launches": int8_launches[name],
                "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"]}

    k6_worst = max(k6, key=lambda st: st["max_abs_err"])
    print(json.dumps({"kernels": [
        {**row("mha", "mha.cu", "mars5_tts_tpu/ops/pallas/mha.py:46", main_res),
         "max_abs_err": max(main_res["max_abs_err"], second["max_abs_err"])},
        {**row("fused_linear", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:111",
               w8a8["qkv"]),
         "max_abs_err": max(w8a8[v]["max_abs_err"] for v in ("qkv", "caq", "residual"))},
        row("fused_ffn", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:144",
            w8a8["ffn"]),
        {**row("heads_diffusion_tail", "diffusion_tail.cu",
               "mars5_tts_tpu/ops/pallas/diffusion_tail.py:149", k6[-1]),
         "max_abs_err": k6_worst["max_abs_err"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
