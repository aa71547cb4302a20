#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``mars5_tts_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compiles every CUDA library in ``mars5_tts_torch/csrc`` for
   sm_90a into ``build/kernels/``, one nvcc each, all at once
   (``ops/kernels/build.build_all``).
3. Kernels against their plain PyTorch twins on the card, at the main paths'
   shapes, with stated error bounds and CUDA-event timings: K1 attention
   (beside ``scaled_dot_product_attention``, masked and unmasked, as a
   yardstick the port never calls; with the calls the int8 decoder makes on
   strided views of its qkv projection: 750 queries over 1,200 keys, and the
   smoke request's 725 frames), K3 fused_linear (qkv, caq and residual
   variants), K4 fused_ffn, K6 heads_diffusion_tail (w = 3, at t = 0 and a
   middle t), K5 diffusion_tail (index-identical to K6 and to its twin), K2
   fused_decode_layers (W8 and W4 at the released AR widths, window 2001,
   positions 600 and 1900, then four rows at 600 / 1200 / 1900 / 2400), K8
   head4_logits (1536 -> 24,000, one row and four), K7 decode_attention (the
   bf16 AR's 24 heads of 64 over a 2001-slot ring with the self column: one
   row at 600 and 1900, four rows at 600 / 1200 / 1900 / 2400, the last
   wrapped; clusters sized from the positions' host bound as the AR passes
   it; again at a tensor-parallel rank's 12 heads, one row at 600 and four
   rows; and K1 at such a rank's 8 heads, (2, 1200, 8, 64) masked, as
   strided views of its (2, 1200, 1536) qkv; and at phase 6 (e)'s own
   shapes: K7 at 12 heads over a 221-slot ring at positions 121 and 219, K1
   at (2, 725, 8, 64) and (2, 526, 8, 64) masked on qkv views) and K9 mega_decoder_stack (the int8 NAR decoder's 16 layers at the
   smoke request's shape: each layer alone on the kernel's output of the
   layer before, then all sixteen in one call, with the device time of each
   phase; then at the bench's 1,200 frames), then the modes of the int8
   NAR's other routes: K1's int8 mode at (2, 1200, 16, 64) masked and
   unmasked, at the request's 725 frames and across over its 66-token
   memory (three kernel launches a call, by the C entry's own count), and
   K1's bf16 kernel on that cross-attention; K3 (qkv, caq,
   residual) and K4 with per-K-group scales at gsize 128 (K3 bitwise), with
   the grouped plan's tile and grid per site.
   Every kernel also prints the wrapper's host time (``host_ms``) and its device time (``device_ms``);
   K2, K6, K8 and K9 their kernel launches a call by their C entries' own
   count (K2: one a decode step, K6: two, at most two each allowed; K8: one;
   K9: 1 + 15 a layer); K3 and K4 beside ``torch._int_mm`` at the (M, K, N)
   of their int8 GEMM cores (a yardstick the port never calls there).
   Checks added after the first ones draw from generators of their own, so
   no earlier check's inputs move.
4. Main paths: ``Mars5TTS`` at the released widths (AR 26 x 1536, NAR 8 + 16 x
   1024, Encodec, Vocos) with seeded random weights, serving deep-clone
   ``tts()`` requests with 7 s references (525 prompt frames, so the NAR
   self-attention runs kernel K1), 200 diffusion steps, CFG w = 3: the bf16
   AR with the bf16 NAR, then with ``nar_backend="int8"`` (every reverse step
   runs K1, K3, K4 and K6); then the production path, ``ar_backend="fused4"``
   with the int8 NAR, twice (the first builds the pack and warms up; every
   decode step runs K2), ``ar_backend="fused"`` once, and ``fused4`` with
   ``head4=True`` once (every decode step also runs K8); then fused4 + int8
   with ``nar_mega=True`` (K9 once a reverse step in place of K1, K3 and K4
   in the decoder) and with ``nar_tail="split"`` (the folded heads, then K5,
   in place of K6). The bf16 AR runs K7 once a layer a decode step; the
   quantized AR never does. Then the batched path, ``tts_batch``: three
   texts with two voices (7 s and 5 s references, so the NAR takes its
   ragged branch) on fused4 + int8 (K2 once a batched step for all rows, K7
   0, K6 200), and two texts with one voice on the bf16 AR + int8 NAR (K7 26
   times a batched step). Then the int8 NAR's other routes on fused4: (a)
   ``nar_gsize=128`` (K3 6,400 and K4 3,200 launches, all grouped) and (b)
   ``nar_fused=False, nar_qattn=True, nar_cross_k1=True`` (K1's int8 mode
   16 x 200 on the self- and 16 x 200 on the cross-attention, K3 = K4 = 0).
   The default routes must launch neither new mode. Each request's AR cap
   leaves its longest prompt
   ``GEN_FRAMES`` generated frames. Each request's launch counts are reset
   before it and read after it.

5. Serving, on the int8 NAR of phase 4 at the released widths: the deploy
   configuration (``deploy/predict.py``: fused4 + int8,
   ``guidance_interval=(0, 0.5)``, ``nar_gen_bucket=64``,
   ``nar_text_bucket=32``) through ``tts()`` on the default route and with
   ``nar_mega=True`` (K6 or K9 200 calls: 100 with CFG, 100 on the cond
   rows alone; NAR ms a step beside the default route's); ``stream_tts``
   (segments of 192 frames, 192 of context, a 32-frame margin: at least two
   segments, the streamed PCM one vocode of the emitted grid within atol
   2e-5, rtol 1e-4, the time to the first chunk); ``synthesize_longform``
   over a two-chunk text (the crossfade's length); a
   ``ContinuousBatcher`` of 4 rows on the fused4 engine (chunks of 64 steps,
   prompt buckets 64 and 576) over three shallow and three deep requests on
   injected streams (K2 once a pool step, every row's tokens its solo
   ``ar_generate`` run's, tokens a second beside the solo runs'); a
   ``NarWaveScheduler`` wave of the three deep rows (T = 200 on the
   generator path, then T = 8 on injected streams, each wave row bit for
   bit its one-row wave); ``use_kv_cache=False`` on the bf16 AR (ms a token,
   tokens beside the cached run's, not a gate). Before the requests, phase 3
   also holds the new shapes against their twins: K1 at one batch row
   (1, 1200) masked, K3/K4 at M = 1200 (one row), K6 and K5 with the cond
   rows alone, the greedy last step (``scalars[5] = 0``) and a wave of three
   rows; after them, K9 at one row, (1, 725) and (1, 1200). Last of all
   (the profiler slows what follows it), the device's idle share of the
   pool's run and of a three-row wave at T = 20.

6. Training, data- and tensor-parallel decoding, after every earlier measurement: (a)
   the port's ``train.make_train_step`` at the released widths
   (``CodecLMConfig.mars5(24_000)``, ``ResidualTransformerConfig.mars5(4_096)``,
   f32, TF32 off), two ``data.synthetic_corpus`` utterances of 60 text tokens
   and 450 frames, ``MultinomialDiffusion(1025, timesteps=200)``, AdamW at lr
   1e-4, weight decay 0.01, clip 1.0: one warm step, then five timed steps on
   the one batch and one set of NAR draws (AR and NAR ms a step with the
   device synchronised, AR tokens a second, peak ``max_memory_allocated``,
   both losses at each step; gate: all finite, each loss at step 5 below its
   loss at step 1), then once more with ``remat=True`` (peak memory beside);
   (b) at full width and two layers each, one step's losses and the
   gradient norms of eight named parameters on the card against the CPU
   (losses within rtol 1e-5, norms within 1e-4 relative); (c) a NAR forward
   at 600 frames with grad enabled must raise (kernel K1 has no backward);
   (d) ``serving.multichip.ShardedARDecoder`` in a one-process NCCL group
   (dp = 1) on the served bf16 AR: its tokens bitwise those of
   ``ar_generate_batched`` (K7's launches read around it); (e) tensor
   parallelism at dp 1 x tp 2 (``tools/tp_card.py``): two processes of one
   gloo group share the card (NCCL takes one rank a device), each building
   phase 4's bf16 AR and NAR from its seed and keeping its half
   (``ShardedARDecoder`` / ``ShardedNARDiffusion``). Rank 0 first runs one
   process's references on the whole models: a 120-token prompt's AR
   request capped at 100 new tokens, its teacher-forced logits in bf16 and
   with the weights in f32, and a deep-clone NAR grid (525 prompt and 200
   new frames, T = 20, w = 3) in bf16 and in f32. Then both ranks run the
   request and the grid (timed, the launches counted), then the
   teacher-forced logits of rank 0's tokens and the grid again with every
   K7 and K1 call held against its twin on the same inputs. Gates: the
   ranks' tokens, grid and logits equal; the logits within 3x the bf16
   model's own distance from f32 of one process's, and the share of grid
   cells that differ from one process's within 3x the share by which its
   bf16 grid differs from its f32 grid (``tp_card.check``); every held K7
   and K1 call within its twin's bound; K7 26 launches a decode step and
   K1 16 a reverse step plus 3 (the speaker encoder) on each rank.
   Reported: the tokens that agree with one process's before the first
   difference (beside how far one process's bf16 and f32 runs agree), the
   shapes each kernel was held at, each rank's ms a token and a step
   beside one process's (ranks sharing a card over gloo: not
   tensor-parallel speed).

7. The entry points from files on disk, after phase 5 and before anything
   runs the profiler, on phase 4's seeded models: (a) the AR and NAR written
   by ``hub.save_checkpoint`` (f32 leaves, the tokenizers and the config;
   safetensors where it imports, else the reference's .pt layout), Encodec
   and Vocos as official-key state dicts (weight-norm ``weight_g`` /
   ``weight_v`` convs) and the request's 7 s reference as a PCM16 WAV, in a
   temporary directory under ``build/`` that the phase removes, pass or
   fail; (b) one deep-clone request through ``cli.main`` (the card by
   default; the load and stage seconds), whose WAV must equal
   ``Mars5TTS.from_local(...).tts`` on the same files and seed sample for
   sample, K7 26 launches a decode step and K1 at least 16 a reverse step;
   (c) ``deploy.predict.Predictor().setup()`` from the environment and
   ``predict``: phase 5's deploy launch checks (K2 once a decode step, K6
   100 CFG + 100 cond-only calls, K3 6,400, K4 3,200), its NAR ms a step
   beside phase 5's; again with ``MARS5_NAR_MEGA=1`` (K9 200); (d)
   ``quantize_codeclm`` (weight-only) under the bf16 engine, one request:
   every generated token in the vocabulary window, its AR ms a token beside
   phase 4's bf16 AR.

8. Kernel K10 and the DeepSeek-V2-Lite AR, after phase 7 and before the
   profiler, at the widths and depth of ``portbench/configs/
   mars5-dsv2lite.json``'s ``ar`` block (``dsv2lite_config``): (a) K10
   ``moe_decode`` at 1 and 8 rows of 2,048 (64 experts of 1,408, top 6, the
   shared pair as one SwiGLU of 2,816), 16 routings each from a softmax over
   random gate weights, every output within one ulp of its twin
   (``one_ulp``), timed over the 16 routings (each call's experts cold in
   L2), its bound the distinct experts' bytes over 3.35 TB/s (138.4 MB at
   one row); (b) that AR (14 layers, bf16, seeded random weights) with the
   configuration's options beside phase 4's int8 NAR, serving one
   deep-clone request of phase 4 with the counts at 0 before it: K10 13
   launches a decode step (the step graphed), K7 and K2 none; then the same
   request with the step eager and every K10 call held against its twin
   within one ulp, its grid equal to the graphed request's.

A phase that fails prints ``chip_smoke: phase <name> failed: ...`` before
the traceback.

After the requests (``torch.profiler`` slows a process's later launches),
the device time of each launch of K3 and K4 (prologue and GEMM; K4's four)
at one group and grouped, and the grouped calls' device time with their
GEMMs forced to each tile width, beside the plan's, at M = 2400 and at a
short request's M = 800 (where the plan takes 64-wide tiles for caq, the
residual sites and lin2), and the device time of each launch of K1's int8
mode (its two pre-pass kernels and the attention) at its four shapes. The
build prints the ptxas registers and spills of every K3/K4 GEMM
instantiation and of K1's three int8 kernels and fails on a spill or a
missing log.

Every kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over the H100 SXM peak for their type
(int8 1,979 TOP/s, bf16 989 TFLOP/s), from the inputs of this run.

Prints one JSON line with the kernels' results, then as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing a result.
"""

import gc
import json
import statistics
import subprocess
import sys
import time
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
SHORT_M = 800                       # the grouped tile A/B's short request: 2 x 400 frames
GEN_LEN, LANES, CLASSES = 750, 7, 1025
AR_MAX_LEN = 2000                   # K2 check: window min(3000, 2001)
AR_POSITIONS = (600, 1900)
BATCH_POSITIONS = (600, 1200, 1900, 2400)     # four rows, the last past the window
K7_CASES = ((600,), (1900,), BATCH_POSITIONS)
TP = 2                              # phase 6 (e): two ranks share the card
K7_TP_CASES = ((600,), BATCH_POSITIONS)     # a tp rank's 24 / TP heads, one row and four
K1_TP_SHAPE = (2, 1200, 16 // TP, 64)      # a tp rank's NAR self-attention heads
# phase 6 (e)'s own shapes: K7 over its AR's 221-slot ring (120 prompt ids +
# a 100-token cap + 1) at the first and last decode positions; K1 on a
# rank's qkv views in the NAR decoder (525 prompt + 200 frames) and the
# speaker encoder (the identity + 525 frames), two CFG rows each
K7_TP_RING, K7_TP_RING_CASES = 221, ((121,), (219,))
K1_TP_RUN_SHAPES = ((2, 725, 16 // TP, 64), (2, 526, 16 // TP, 64))
HBM_BYTES_S = 3.35e12               # H100 SXM data sheet
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
# K9 at the smoke request's shape: 7 s reference = 525 prompt frames + up to
# 200 generated, two CFG rows; 66 encoder tokens (the deep-clone text + speaker)
MEGA_L, MEGA_LK = 725, 66
MEGA_BENCH_L = 1200                 # K9 also at the bench's frames (bench.py:47-49)
GSIZE = 128                         # the grouped request's K group (QMODES_r05.json's g128)


def bound(nbytes, **ops):
    """(bound_ms, bound_by): the larger of moving ``nbytes`` at the HBM rate
    and doing ``ops`` (type -> count) at each type's peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[k] for k, n in ops.items())
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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


def device_ms(fn, n=20):
    """Device milliseconds of one call of ``fn``, the wrapper's host time
    left out: ``n`` calls queued behind a spin kernel, so the host has
    queued them all before the card reaches them, and CUDA events time the
    card alone. Their launches must fit the device's launch queue (about a
    thousand: a full queue blocks the host until the spin ends). None if the
    host could not queue them within the spin.
    Phase 3 does not use ``torch.profiler``: once it has traced a process,
    every later launch costs more host time, which would slow the
    launch-bound AR of phase 4 (PERF.md, PR 5)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for cycles in (10 ** 8, 10 ** 9):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / n
    return None


def host_ms(fn, n=50, warmup=5):
    """Host milliseconds of one call of ``fn``: the wall time of ``n`` calls
    queued back to back without a synchronisation (the wrapper's Python,
    its checks and the launch), over ``n``; the card runs behind."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return 1e3 * t


def kernel_launches_per_call(module, fn):
    """CUDA kernels one call of ``fn`` launches, by the C entry's own count
    (``module.kernel_launches``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    n0 = module.kernel_launches()
    fn()
    torch.cuda.synchronize()
    return module.kernel_launches() - n0


def sm_count(dev):
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fmt_us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def own_generator(dev, seed=5):
    """A generator of its own for a check added after the others, so their
    inputs do not depend on it."""
    import torch
    return torch.Generator(device=dev).manual_seed(seed)


def check_kernel(K, shape, masked, dtype, gen, dev, lk=None, q_start=0):
    """K1 at ``shape`` (B, L, H, D) against its twin, timed beside the
    library call (``scaled_dot_product_attention``, masked and, for bf16,
    unmasked too) and with the wrapper's host time. ``lk`` given: q, k and v
    are strided views of one (B, lk, 3 H D) projection, as the int8 decoder
    slices them, and the queries start at ``q_start`` (its last layer takes
    750 of 1,200)."""
    import torch
    b, l, h, d = shape
    if lk is None:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    else:
        qkv = torch.randn((b, lk, 3 * h * d), generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, lk, h, d) for i in range(3))
        q = q[:, q_start:]
    lk = k.shape[1]
    mask = None
    if masked:
        mask = torch.zeros((b, lk), dtype=torch.bool, device=dev)
        mask[-1, lk - lk // 6:] = True          # pad the tail of the last row
    out = K.mha(q, k, v, mask)
    ref = K.mha_ref(q, k, v, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"K1 {shape}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        tol = K.bf16_row_bound(ref)
        bound_txt = "2 bf16 ulp of each row's peak"
    else:
        tol = torch.full_like(diff, 1e-5) * ref.float().abs().max().clamp_min(1.0)
        bound_txt = "1e-5 x max(1, peak)"
    ok = bool((diff <= tol).all())
    res = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "ms": cuda_ms(lambda: K.mha(q, k, v, mask)),
           "plain_ms": cuda_ms(lambda: K.mha_ref(q, k, v, mask)),
           "device_ms": device_ms(lambda: K.mha(q, k, v, mask)),
           "host_ms": host_ms(lambda: K.mha(q, k, v, mask))}
    keys = lk * b if mask is None else int((~mask).sum())
    res["bound_ms"], res["bound_by"] = bound(nbytes(q, k, v, out, mask),
                                             bf16=4 * h * q.shape[1] * d * keys)
    lib_txt = ""
    if dtype == torch.bfloat16:     # the library yardstick, never called by the port
        import torch.nn.functional as Fn
        res["encode_us"] = K.tensor_map_encode_us(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = None if mask is None else ~mask[:, None, None, :]
        res["library_ms"] = cuda_ms(lambda: Fn.scaled_dot_product_attention(qt, kt, vt, am))
        lib_txt = f", sdpa {res['library_ms'] * 1e3:.1f} us"
        if mask is not None:
            res["library_unmasked_ms"] = cuda_ms(
                lambda: Fn.scaled_dot_product_attention(qt, kt, vt))
            lib_txt += f" (unmasked {res['library_unmasked_ms'] * 1e3:.1f} us)"
    enc_txt = (f" of which {res['encode_us']:.2f} us encode the tensor maps"
               if "encode_us" in res else "")
    views = "" if q.is_contiguous() else f", strided views of a (B, {lk}, {3 * h * d}) qkv"
    print(f"K1 {tuple(q.shape)} over {lk} keys {str(dtype).split('.')[-1]} mask={masked}{views}: "
          f"max_abs_err={res['max_abs_err']:.3e} mean_abs_err={res['mean_abs_err']:.3e} "
          f"bound={bound_txt} (max {tol.max().item():.3e}) within={ok} | "
          f"kernel {res['ms'] * 1e3:.1f} us (device {fmt_us(res['device_ms'])}, wrapper host "
          f"{res['host_ms'] * 1e3:.1f} us{enc_txt}), plain {res['plain_ms'] * 1e3:.1f} us"
          f"{lib_txt}, roofline {res['bound_ms'] * 1e3:.1f} us ({res['bound_by']})", flush=True)
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
             "exact_frac": (g == w).float().mean().item(), "peak": peak}
    ok = (stats["max_abs_err"] <= 0.02 * peak and stats["exact_frac"] > 0.95
          and stats["mean_abs_err"] < 2e-3 * peak and bool(torch.isfinite(g).all()))
    return ok, stats


def rand_qweight(n, k, gen, dev):
    import torch
    from mars5_tts_torch.ops.quant import quantize_weight
    return quantize_weight(torch.randn((n, k), generator=gen, device=dev) * 0.03)


def check_w8a8(name, run, twin, moved, int8_ops, min_exact):
    """One K3/K4 variant against its twin: within the fused bound and at
    least ``min_exact`` of the elements exactly equal; CUDA-event times, the
    device time (``device_ms``) and the wrapper's host time (``host_ms``);
    ``moved`` the bytes it must move, ``int8_ops`` its operations."""
    import torch
    out = run()
    ref = twin()
    torch.cuda.synchronize()
    ok, st = fused_bound(out, ref)
    ok = ok and st["exact_frac"] >= min_exact
    st.update(ms=cuda_ms(run), plain_ms=cuda_ms(twin), device_ms=device_ms(run),
              host_ms=host_ms(run))
    st["bound_ms"], st["bound_by"] = bound(moved + nbytes(out), int8=int8_ops)
    st["run"] = run           # for w8a8_launch_split, after the requests
    rate = "not measured"
    if st["device_ms"] is not None:
        st["tops"] = int8_ops / (st["device_ms"] * 1e-3) / 1e12
        rate = f"{st['tops']:.0f} TOP/s, {100 * st['tops'] * 1e12 / PEAK_OPS_S['int8']:.1f}% of peak"
    print(f"{name}: max_abs_err={st['max_abs_err']:.3e} mean_abs_err={st['mean_abs_err']:.3e} "
          f"exact={st['exact_frac']:.5f} bound=fused_eq(0.02 peak, mean<2e-3 peak) and exact >= "
          f"{min_exact} within={ok} | kernel {st['ms'] * 1e3:.1f} us (device "
          f"{fmt_us(st['device_ms'])}, {rate}; wrapper host {st['host_ms'] * 1e3:.1f} us), plain "
          f"{st['plain_ms'] * 1e3:.1f} us, roofline {st['bound_ms'] * 1e3:.1f} us "
          f"({st['bound_by']})", flush=True)
    if not ok:
        raise RuntimeError(f"{name}: error above its bound")
    return st


INT_MM_SHAPES = {"qkv": ((DIM, 3 * DIM),), "caq": ((DIM, DIM),),
                 "ffn": ((DIM, 2 * FFN), (FFN, DIM))}     # (K, N) of each GEMM


def check_int_mm(gen, dev):
    """``torch._int_mm`` (cuBLAS) at the (M, K, N) of the int8 GEMM cores of
    K3 and K4: a yardstick for the GEMM alone (no LN, quant or epilogue), so
    not the same function; the port never calls it on these sites."""
    import torch
    res, txt = {}, []
    for name, shapes in INT_MM_SHAPES.items():
        ops = [(torch.randint(-127, 128, (M_ROWS, k), generator=gen, device=dev,
                              dtype=torch.int8),
                torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t())
               for k, n in shapes]

        def run():
            for a, b in ops:
                torch._int_mm(a, b)
        res[name] = {"ms": cuda_ms(run), "device_ms": device_ms(run)}
        txt.append(f"{name} " + " + ".join(f"({M_ROWS}, {k}) x ({k}, {n})" for k, n in shapes)
                   + f" {res[name]['ms'] * 1e3:.1f} us (device {fmt_us(res[name]['device_ms'])})")
    print("torch._int_mm (cuBLAS int8 GEMM alone, the yardstick of K3/K4's GEMM cores; never "
          "called by the port here): " + ", ".join(txt), flush=True)
    return res


def check_nar_fused(gen, dev):
    """K3 (qkv with LN + bias, caq, residual; 100% equal to the twin) and K4
    (at least 99.9% equal) at the decoder's shapes, with its bf16 LN and bias
    vectors."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)

    x = torch.randn((2, M_ROWS // 2, DIM), generator=gen, device=dev).to(torch.bfloat16)
    ln = (vec(DIM, 1.0), vec(DIM))
    qkv_w = rand_qweight(3 * DIM, DIM, gen, dev)
    qkv_b = vec(3 * DIM)
    sq_w = rand_qweight(DIM, DIM, gen, dev)
    sq_b = vec(DIM)
    res = {}
    res["qkv"] = check_w8a8(
        "K3 qkv (2, 1200, 1024) -> 3072, LN + bias",
        lambda: F.fused_linear(x, qkv_w, ln=ln, bias=qkv_b),
        lambda: F.fused_linear_ref(x, qkv_w, ln=ln, bias=qkv_b),
        nbytes(x, *qkv_w, qkv_b, *ln), 2 * M_ROWS * 3 * DIM * DIM, 1.0)
    res["caq"] = check_w8a8(
        "K3 caq (2, 1200, 1024) -> 1024, LN + bias",
        lambda: F.fused_linear(x, sq_w, ln=ln, bias=sq_b),
        lambda: F.fused_linear_ref(x, sq_w, ln=ln, bias=sq_b),
        nbytes(x, *sq_w, sq_b, *ln), 2 * M_ROWS * DIM * DIM, 1.0)
    a = (x * 0.5).contiguous()
    res["residual"] = check_w8a8(
        "K3 residual (2, 1200, 1024) -> 1024, bias + residual",
        lambda: F.fused_linear(a, sq_w, bias=sq_b, residual=x),
        lambda: F.fused_linear_ref(a, sq_w, bias=sq_b, residual=x),
        nbytes(a, *sq_w, sq_b, x), 2 * M_ROWS * DIM * DIM, 1.0)
    w, v = rand_qweight(FFN, DIM, gen, dev), rand_qweight(FFN, DIM, gen, dev)
    l2 = rand_qweight(DIM, FFN, gen, dev)
    l2_b = vec(DIM)
    res["ffn"] = check_w8a8(
        "K4 ffn (2, 1200, 1024), F 3072",
        lambda: F.fused_ffn(x, ln, w, v, l2, l2_b),
        lambda: F.fused_ffn_ref(x, ln, w, v, l2, l2_b),
        nbytes(x, *ln, *w, *v, *l2, l2_b), 2 * M_ROWS * 3 * DIM * FFN, 0.999)
    res["int_mm"] = check_int_mm(own_generator(dev, 13), dev)
    return res


def check_k1_modes(dev):
    """K1's modes of the unfused int8 decoder (``nar_fused=False``): the int8
    mode (``nar_qattn``) at the bench's (2, 1200, 16, 64), masked and
    unmasked, and at the smoke request's 725 frames, self-attention on
    strided views of a (2, L, 3072) qkv projection and cross-attention
    (``nar_cross_k1``) over the 66-token memory (k, v views of its (2, 66,
    2048) projection), within ``mha.int8_bound`` of the twin (two one-step
    p8 changes and a bf16 ulp, printed beside the error); then the bf16
    kernel on the same cross-attention, within 2 bf16 ulp of each row's peak.
    The int8 mode has no single PyTorch call (``library_ms`` None);
    ``scaled_dot_product_attention`` in bf16 is printed beside it as a
    yardstick."""
    import torch
    import torch.nn.functional as Fn
    from mars5_tts_torch.ops.kernels import mha as K

    gen = own_generator(dev, 21)
    h, d = MAIN_SHAPE[2], MAIN_SHAPE[3]

    def views(b, lq, lk, cross):
        if not cross:
            qkv = torch.randn((b, lq, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
            return [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, lq, h, d) for i in range(3)]
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((b, lk, 2 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        return [q] + [kv[..., i * h * d:(i + 1) * h * d].reshape(b, lk, h, d) for i in range(2)]

    res = {}
    for name, (b, lq, lk), cross, masked, quantized in (
            ("int8 (2, 1200) masked", (2, 1200, 1200), False, True, True),
            ("int8 (2, 1200)", (2, 1200, 1200), False, False, True),
            ("int8 (2, 725) strided", (2, MEGA_L, MEGA_L), False, True, True),
            ("int8 cross (2, 725) over 66", (2, MEGA_L, MEGA_LK), True, True, True),
            ("bf16 cross (2, 725) over 66", (2, MEGA_L, MEGA_LK), True, True, False)):
        q, k, v = views(b, lq, lk, cross)
        mask = None
        if masked:
            mask = torch.zeros((b, lk), dtype=torch.bool, device=dev)
            mask[-1, lk - lk // 6:] = True
        def run(q=q, k=k, v=v, mask=mask, quantized=quantized):     # this case's inputs
            return K.mha(q, k, v, mask, quantized=quantized)
        out = run()
        if quantized:
            ref, tol = K.int8_bound(q, k, v, mask)
            bound_txt = "2 p8 steps (2 vs / r) + 1 bf16 ulp"
        else:
            ref = K.mha_ref(q, k, v, mask)
            tol = K.bf16_row_bound(ref)
            bound_txt = "2 bf16 ulp of each row's peak"
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        ok = bool(torch.isfinite(out).all()) and bool((diff <= tol).all())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        am = None if mask is None else ~mask[:, None, None, :]
        sdpa_ms = cuda_ms(lambda: Fn.scaled_dot_product_attention(qt, kt, vt, am))
        st = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
              "max_bound": tol.max().item(), "min_bound": tol.min().item(),
              "ms": cuda_ms(run), "plain_ms": cuda_ms(lambda: K.mha_ref(q, k, v, mask, quantized)),
              "device_ms": device_ms(run), "host_ms": host_ms(run),
              "library_ms": None if quantized else sdpa_ms, "sdpa_yardstick_ms": sdpa_ms,
              "kernel_launches_per_call": kernel_launches_per_call(K, run),
              "run": run}           # for k1_int8_launch_split, after the requests
        ok = ok and st["kernel_launches_per_call"] == (3 if quantized else 1)
        keys = lk * b if mask is None else int((~mask).sum())
        ops = 4 * h * lq * d * keys
        st["bound_ms"], st["bound_by"] = bound(nbytes(q, k, v, out, mask),
                                               **({"int8": ops} if quantized else {"bf16": ops}))
        print(f"K1 {name} {tuple(q.shape)} over {lk} keys mask={masked}: max_abs_err="
              f"{st['max_abs_err']:.3e} mean_abs_err={st['mean_abs_err']:.3e} bound={bound_txt} "
              f"(per element, {st['min_bound']:.3e} .. {st['max_bound']:.3e}) within={ok} | "
              f"kernel {st['ms'] * 1e3:.1f} us (device {fmt_us(st['device_ms'])}, wrapper host "
              f"{st['host_ms'] * 1e3:.1f} us; {st['kernel_launches_per_call']} kernel launches a "
              f"call), plain {st['plain_ms'] * 1e3:.1f} us, sdpa bf16 "
              f"{sdpa_ms * 1e3:.1f} us{'' if quantized else ' (library)'}, roofline "
              f"{st['bound_ms'] * 1e3:.1f} us ({st['bound_by']})", flush=True)
        if not ok:
            raise RuntimeError(f"K1 {name}: error above its bound or other kernels a call")
        res[name] = st
    return res


def check_nar_fused_grouped(dev, m=M_ROWS):
    """K3 and K4 with per-K-group scales at gsize 128 (``nar_gsize=128``) at
    the decoder's shapes over ``m`` rows (two CFG rows of m / 2 frames): K3
    qkv (G = 8 weight groups), caq (8 activation groups over per-row weight
    scales) and a residual site (saout), bitwise equal to the twin; K4 (G = 8
    for W and V, 24 for lin2) within the fused bound and at least 99.9% equal
    (the GEMMs exact, the sigmoid's expf as at one group)."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F
    from mars5_tts_torch.ops.quant import quantize_weight_grouped

    gen = own_generator(dev, 22)
    gs = 128

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)

    def gweight(n, k):
        return quantize_weight_grouped(torch.randn((n, k), generator=gen, device=dev) * 0.03, gs)

    x = torch.randn((2, m // 2, DIM), generator=gen, device=dev).to(torch.bfloat16)
    ln = (vec(DIM, 1.0), vec(DIM))
    g1, g2 = DIM // gs, FFN // gs
    sms = sm_count(dev)
    sites = grouped_sites(m)
    plans = {site: F.gemm_plan(*shape, sms, True) for site, shape in sites.items()}
    print(f"K3/K4 grouped plan on {sms} SMs (tile rows x weight rows, persistent grid): "
          + ", ".join(f"{site} {shape[:3]}{' mode 1' if shape[3] else ''}: 128 x {bn}, grid "
                      f"{grid}" for (site, shape), (bn, grid)
                      in zip(sites.items(), plans.values())), flush=True)
    rows = f"(2, {m // 2}, 1024)"
    qkv_w, qkv_b = gweight(3 * DIM, DIM), vec(3 * DIM)
    caq_w, caq_b = rand_qweight(DIM, DIM, gen, dev), vec(DIM)
    out_w, out_b = gweight(DIM, DIM), vec(DIM)
    a = (x * 0.5).contiguous()
    res = {}
    res["qkv"] = check_w8a8(
        f"K3 grouped qkv {rows} -> 3072, G = {g1}, LN + bias",
        lambda: F.fused_linear(x, qkv_w, ln=ln, bias=qkv_b, groups=g1),
        lambda: F.fused_linear_ref(x, qkv_w, ln=ln, bias=qkv_b, groups=g1),
        nbytes(x, *qkv_w, qkv_b, *ln), 2 * m * 3 * DIM * DIM, 1.0)
    res["caq"] = check_w8a8(
        f"K3 grouped caq {rows} -> 1024, {g1} activation groups, per-row weights",
        lambda: F.fused_linear(x, caq_w, ln=ln, bias=caq_b, groups=g1),
        lambda: F.fused_linear_ref(x, caq_w, ln=ln, bias=caq_b, groups=g1),
        nbytes(x, *caq_w, caq_b, *ln), 2 * m * DIM * DIM, 1.0)
    res["residual"] = check_w8a8(
        f"K3 grouped residual {rows} -> 1024, G = {g1}, bias + residual",
        lambda: F.fused_linear(a, out_w, bias=out_b, residual=x, groups=g1),
        lambda: F.fused_linear_ref(a, out_w, bias=out_b, residual=x, groups=g1),
        nbytes(a, *out_w, out_b, x), 2 * m * DIM * DIM, 1.0)
    w, v, l2 = gweight(FFN, DIM), gweight(FFN, DIM), gweight(DIM, FFN)
    l2_b = vec(DIM)
    res["ffn"] = check_w8a8(
        f"K4 grouped ffn {rows}, F 3072, G = {g1} / {g2}",
        lambda: F.fused_ffn(x, ln, w, v, l2, l2_b, groups=g1, groups2=g2),
        lambda: F.fused_ffn_ref(x, ln, w, v, l2, l2_b, groups=g1, groups2=g2),
        nbytes(x, *ln, *w, *v, *l2, l2_b), 2 * m * 3 * DIM * FFN, 0.999)
    res["plan"] = plans
    return res


def grouped_sites(m):
    """(M, N, K, mode) of the grouped K3 / K4 GEMMs at the decoder's shapes
    over m rows."""
    return {"qkv": (m, 3 * DIM, DIM, 0), "caq": (m, DIM, DIM, 0), "residual": (m, DIM, DIM, 0),
            "WV": (m, FFN, DIM, 1), "lin2": (m, DIM, FFN, 0)}
W8A8_KERNELS = ("w8a8_prologue", "w8a8_wgmma_gemm", "w8a8_wgmma_swiglu")


MHA_KERNELS = ("mha_",)


def launch_split(run, n=5, kernels=None):
    """Device microseconds of each kernel one call of ``run`` launches, in
    launch order: [(kernel with its template arguments, median us over n
    profiled calls)], from ``torch.profiler``'s kernel records of the
    kernels whose names hold one of ``kernels`` (default ``W8A8_KERNELS``);
    None when it records none. Run it after the requests (the profiler slows
    a process's later launches: PERF.md)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels = kernels or W8A8_KERNELS
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if any(k in e.name for k in kernels)),
                  key=lambda e: e.time_range.start)
    if not kern or len(kern) % n:
        return None
    per = len(kern) // n
    out = []
    for i in range(per):
        m = re.search(r"((?:%s)\w*)(<[^>]*>)?" % "|".join(map(re.escape, kernels)), kern[i].name)
        us = [kern[i + j * per].time_range.elapsed_us() for j in range(n)]
        out.append((m.group(0) if m else kern[i].name, statistics.median(us)))
    return out


def ring_bytes(m, n, k, mode, tile_b):
    """Bytes a K3/K4 GEMM's TMA ring pulls from L2: every tile's 128-deep
    stages, 128 rows of A and tile_b weight rows each."""
    cols = tile_b if mode == 0 else tile_b // 2
    return -(-m // 128) * -(-n // cols) * (k // 128) * 128 * (128 + tile_b)


def w8a8_launch_split(one_group, grouped):
    """Prints and returns the per-launch device split of K3 (prologue, GEMM)
    and K4 (prologue, W and V GEMM, u's prologue, lin2) at one group and
    grouped, from the results of ``check_nar_fused`` /
    ``check_nar_fused_grouped``; beside each GEMM, the bytes its ring pulls
    from L2 (``ring_bytes``, at the plan's tile) over its device time."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F

    out, sms = {}, sm_count(torch.cuda.current_device())
    for tag, res in (("", one_group), ("grouped ", grouped)):
        for site in ("qkv", "caq", "residual", "ffn"):
            if site not in res or "run" not in res[site]:
                continue
            split = launch_split(res[site]["run"])
            name = f"K{4 if site == 'ffn' else 3} {tag}{site}"
            out[name] = split
            gemms = [grouped_sites(M_ROWS)[s] for s in (("WV", "lin2") if site == "ffn" else (site,))]
            txt = "not measured"
            if split is not None:
                parts = []
                for kname, us in split:
                    if "wgmma" in kname and gemms:
                        shape = gemms.pop(0)
                        tile_b = F.gemm_plan(*shape, sms, tag != "")[0]
                        nb = ring_bytes(*shape, tile_b)
                        kname += f" {us:.1f} (ring {nb / 1e6:.1f} MB, {nb / us / 1e6:.2f} TB/s)"
                    else:
                        kname += f" {us:.1f}"
                    parts.append(kname)
                txt = ", ".join(parts) + f" (sum {sum(us for _, us in split):.1f})"
            print(f"{name} per launch, device us (torch.profiler, median of 5 calls): {txt}",
                  flush=True)
    return out


def k1_int8_launch_split(k1_modes):
    """Prints and returns the per-launch device split of K1's int8 mode at
    ``check_k1_modes``' four int8 shapes: {case: [(kernel, us)]}, the two
    pre-pass kernels and the attention."""
    out = {}
    for name, st in k1_modes.items():
        if not name.startswith("int8"):
            continue
        split = out[name] = launch_split(st["run"], kernels=MHA_KERNELS)
        txt = "not measured" if split is None else (
            ", ".join(f"{k} {us:.1f}" for k, us in split)
            + f" (sum {sum(us for _, us in split):.1f}; pre-pass "
            f"{sum(us for k, us in split if 'prepass' in k):.1f})")
        print(f"K1 {name} per launch, device us (torch.profiler, median of 5 calls): {txt}",
              flush=True)
    return out


def grouped_tile_ab(grouped, m=M_ROWS):
    """The device time of each grouped K3/K4 call of ``check_nar_fused_grouped``
    over m rows with its grouped GEMMs forced to each tile width
    (``nar_fused.TILE_B_GROUPED``) beside the plan's choice, a check of the
    wave-tail rule; each forced output must equal the plan's bit for bit.
    Returns {site: {width: device ms}}."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F

    plan, out = F.gemm_plan, {}
    for site in ("qkv", "caq", "residual", "ffn"):
        if site not in grouped or "run" not in grouped[site]:
            continue
        run = grouped[site]["run"]
        want, times = run(), {}
        try:
            for bn in F.TILE_B_GROUPED:
                F.gemm_plan = (lambda m, n, k, mode, sms=F.H100_SMS, grouped=False, bn=bn:
                               F.wave_plan(m, n, k, mode, (bn,), sms) if grouped
                               else plan(m, n, k, mode, sms))
                if not torch.equal(run(), want):
                    raise RuntimeError(f"grouped {site} at {bn}-wide tiles differs from the plan's")
                times[bn] = device_ms(run)
        finally:
            F.gemm_plan = plan
        out[site] = times
        print(f"K{4 if site == 'ffn' else 3} grouped {site} M = {m} tile A/B, device us: plan "
              f"{fmt_us(grouped[site]['device_ms'])}, "
              + ", ".join(f"all {bn}-wide {fmt_us(ms)}" for bn, ms in times.items()), flush=True)
    return out


def ptxas_lines(log, kernels):
    """{kernel, with its template arguments if it has any: "N registers, S
    bytes spill stores, L bytes spill loads"} of the entry functions whose
    names start with one of ``kernels`` in an nvcc -Xptxas -v log, and
    [ptxas lines about wgmma instructions or a performance loss]
    (serialisation warnings)."""
    import re
    out, cur, spill = {}, None, ""
    pat = re.compile(r"(?<![A-Za-z])((?:%s)[a-z0-9_]*)" % "|".join(map(re.escape, kernels)))
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", ln)
        if m:
            # ..._<len><name>[I<template arguments>E]...: the (lower-case)
            # name, then its int and bool arguments
            n = pat.search(m.group(1))
            cur = None
            if n:
                rest = m.group(1)[n.end():]
                args = re.findall(r"L[ib](\d+)E", rest) if rest.startswith("I") else []
                cur = n.group(1) + (f"<{', '.join(args)}>" if args else "")
            continue
        if cur and "spill" in ln:
            spill = ", ".join(p.strip() for p in ln.split(",")[1:])
        elif cur and "Used" in ln and "registers" in ln:
            out[cur] = re.search(r"Used \d+ registers", ln).group(0)[5:] + ", " + spill
            cur = None
    return out, [ln.strip() for ln in log.splitlines()
                 if "wgmma." in ln or "Performance Loss" in ln]


def check_ptxas(lib, kernels):
    """Prints the ptxas registers and spills of ``lib``'s kernels named by
    ``kernels`` (this build's log, or the one kept beside a library built
    before) and raises on a spill, or when the log names none of them."""
    from mars5_tts_torch.ops.kernels import build
    regs, wgmma_lines = ptxas_lines(build.build_log.get(lib, ""), kernels)
    for name, txt in sorted(regs.items()):
        print(f"build: {lib} ptxas {name}: {txt}", flush=True)
    for ln in wgmma_lines:
        print(f"build: {lib} ptxas: {ln}", flush=True)
    spilled = [n for n, txt in regs.items() if not txt.endswith(
        "0 bytes spill stores, 0 bytes spill loads")]
    if spilled or not regs:
        raise RuntimeError(f"{lib} kernels spill or no ptxas log: {spilled}")
    return regs


def check_heads_tail(gen, dev):
    """K6 at the bench shape, w = 3, at t = 0 and a middle t: indices equal to
    the twin's except where the twin's two best scores lie within 1e-5.
    ``max_abs_err`` is the largest shortfall of the twin's score at the
    kernel's index below the twin's best score (0 where they agree). K5 on
    the folded heads' bf16 logits of the same decoder output, uniforms and
    x_t: indices equal to K6's and to its own twin's, exactly (its
    ``max_abs_err`` measured as K6's). Returns (K6 results, K5 results), one
    per t."""
    import torch
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    out = torch.randn((2, GEN_LEN, DIM), generator=gen, device=dev).to(torch.bfloat16)
    x8, xs = nar_heads_prequant(out)
    wf = torch.randn((LANES, CLASSES, DIM), generator=gen, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((LANES, CLASSES), generator=gen, device=dev)}
    diff = MultinomialDiffusion(CLASSES, timesteps=STEPS, device=dev)
    x_t = torch.randint(0, CLASSES, (1, GEN_LEN, LANES), generator=gen, device=dev)
    res, res5 = [], []
    logits = nar_heads_folded(folded, out)
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
        run6 = lambda: D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
        st = {"mismatches": int(mism.sum()), "near_ties": int(near_tie.sum()),
              "max_abs_err": shortfall.max().item(), "kernel_launches_per_call":
                  kernel_launches_per_call(D, run6),
              "ms": cuda_ms(run6),
              "plain_ms": cuda_ms(lambda: D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)),
              "device_ms": device_ms(run6), "host_ms": host_ms(run6)}
        print(f"K6 heads+tail (2, 750, 1024) x (7, 1025) w=3 t={t}: index mismatches "
              f"{st['mismatches']} of {got.numel()} (twin near-ties within 1e-5: "
              f"{st['near_ties']}, mismatches outside them: {bad}) | kernel "
              f"{st['ms'] * 1e3:.1f} us (device {fmt_us(st['device_ms'])}, wrapper host "
              f"{st['host_ms'] * 1e3:.1f} us, {st['kernel_launches_per_call']} kernel launches "
              f"a call), plain {st['plain_ms'] * 1e3:.1f} us", flush=True)
        st["bound_ms"], st["bound_by"] = bound(
            nbytes(x8, xs, *folded.values(), u0, x_t, scal, got),
            int8=2 * x8.shape[0] * GEN_LEN * LANES * CLASSES * DIM)
        if bad or got.min() < 0 or got.max() >= CLASSES:
            raise RuntimeError(f"K6 t={t}: indices differ from the twin outside near-ties")
        if st["kernel_launches_per_call"] > 2:
            raise RuntimeError(f"K6 t={t}: {st['kernel_launches_per_call']} kernels a call")
        res.append(st)

        tail_args = (logits, u0, x_t, scal)
        got5 = D.diffusion_tail(*tail_args, w=3.0, temp=0.7)
        want5 = D.diffusion_tail_ref(*tail_args, w=3.0, temp=0.7)
        torch.cuda.synchronize()
        scores5 = D.logit_scores(*tail_args, w=3.0, temp=0.7)
        st5 = {"vs_k6": int((got5 != got).sum()), "vs_twin": int((got5 != want5).sum()),
               "max_abs_err": (scores5.amax(-1) - scores5.gather(-1, got5[..., None])[..., 0])
               .max().item(),
               "ms": cuda_ms(lambda: D.diffusion_tail(*tail_args, w=3.0, temp=0.7)),
               "plain_ms": cuda_ms(lambda: D.diffusion_tail_ref(*tail_args, w=3.0, temp=0.7)),
               "device_ms": device_ms(lambda: D.diffusion_tail(*tail_args, w=3.0, temp=0.7)),
               "host_ms": host_ms(lambda: D.diffusion_tail(*tail_args, w=3.0, temp=0.7)),
               "heads_ms": cuda_ms(lambda: nar_heads_folded(folded, out))}
        st5["bound_ms"], st5["bound_by"] = bound(nbytes(*tail_args, got5))
        print(f"K5 tail (2, 750, 7, 1025) bf16 logits w=3 t={t}: index mismatches against "
              f"K6 {st5['vs_k6']}, against its twin {st5['vs_twin']} of {got5.numel()} "
              f"(bound: 0) | kernel {st5['ms'] * 1e3:.1f} us (device "
              f"{fmt_us(st5['device_ms'])}, wrapper host {st5['host_ms'] * 1e3:.1f} us), plain "
              f"{st5['plain_ms'] * 1e3:.1f} us, roofline {st5['bound_ms'] * 1e3:.1f} us "
              f"({st5['bound_by']}); the folded heads before it (torch._int_mm + epilogue) "
              f"{st5['heads_ms'] * 1e3:.1f} us", flush=True)
        if st5["vs_k6"] or st5["vs_twin"]:
            raise RuntimeError(f"K5 t={t}: indices differ from K6 or from the twin")
        res5.append(st5)
    return res, res5


def fused_bound_f32(got, want):
    """``fused_bound`` without its exact-fraction clause, for f32 outputs: one
    moved int8 rounding changes every later value a little, so an exact
    fraction says nothing there (kernel and twin sum in f64 and agree bit for
    bit when the card rounds exp, sqrt and division as PyTorch's kernels do):
    |diff| <= 0.02 x max(peak, 1), mean |diff| < 2e-3 x max(peak, 1)."""
    import torch
    g, w = got.float(), want.float()
    peak = max(w.abs().max().item(), 1.0)
    diff = (g - w).abs()
    stats = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
             "exact_frac": (g == w).float().mean().item()}
    ok = (stats["max_abs_err"] <= 0.02 * peak and stats["mean_abs_err"] < 2e-3 * peak
          and bool(torch.isfinite(g).all()))
    return ok, stats


def pack_bytes(fp):
    return sum(fp[k].numel() * fp[k].element_size()
               for k in ("wqkv", "sqkv", "wo", "so", "w13", "s13", "w2", "s2"))


def check_decode_layer(ar, gen, dev):
    """K2 at the released AR widths, W8 and W4, on the model's own packs and
    random int8 rings, at two positions: h, k_new and v_new against the twin."""
    import torch
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    res = {}
    for wbits in (8, 4):
        fp, dims = prepare_fused(ar, AR_MAX_LEN, wbits)
        shape = (dims.n_layers, dims.window, dims.dim)
        (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.randn(shape, generator=gen, device=dev)
                                                 * 0.1) for _ in range(2))
        kvs = torch.stack([ks, vs], dim=1).contiguous()
        eps = ar.cfg.norm_eps
        nbytes = pack_bytes(fp)
        for pos in AR_POSITIONS:
            x = fp["embed"][pos].to(torch.bfloat16)[None]
            args = (fp, x, pos, ck, cv, kvs)
            got = D.fused_decode_layers(*args, dims=dims, norm_eps=eps)
            want = D.fused_step_ref(*args, dims=dims, norm_eps=eps)
            torch.cuda.synchronize()
            st = {"max_abs_err": 0.0, "mean_abs_err": 0.0}
            ok = True
            for name, a, b in zip(("h", "k_new", "v_new"), got, want):
                o, s1 = fused_bound_f32(a, b)
                ok &= o
                st[name] = s1
                st["max_abs_err"] = max(st["max_abs_err"], s1["max_abs_err"])
                st["mean_abs_err"] = max(st["mean_abs_err"], s1["mean_abs_err"])
            run = lambda: D.fused_decode_layers(*args, dims=dims, norm_eps=eps)
            st.update(ms=cuda_ms(run, n=50),
                      plain_ms=cuda_ms(lambda: D.fused_step_ref(*args, dims=dims, norm_eps=eps),
                                       n=5, warmup=1),
                      device_ms=device_ms(run), host_ms=host_ms(run),
                      kernel_launches_per_call=kernel_launches_per_call(D, run),
                      pack_mb=nbytes / 1e6, wbits=wbits, pos=pos)
            st["pack_gb_s"] = nbytes / (st["ms"] * 1e-3) / 1e9
            slots = min(pos, dims.window)        # ring rows the attention reads
            ring = dims.n_layers * slots * (2 * dims.dim + 8)
            st["bound_ms"], st["bound_by"] = bound(
                nbytes + ring, int8=2 * nbytes * (2 if wbits == 4 else 1))
            print(f"K2 W{wbits} ({dims.n_layers} x {dims.dim}, hidden {dims.hidden}, window "
                  f"{dims.window}) pos={pos}: h max_abs_err={st['h']['max_abs_err']:.3e} "
                  f"(exact {st['h']['exact_frac']:.3f}), k_new {st['k_new']['max_abs_err']:.3e}, "
                  f"v_new {st['v_new']['max_abs_err']:.3e}; bound=fused_eq without the exact "
                  f"fraction (f32) within={ok} | kernel {st['ms'] * 1e3:.1f} us (device "
                  f"{fmt_us(st['device_ms'])}, wrapper host {st['host_ms'] * 1e3:.1f} us, "
                  f"{st['kernel_launches_per_call']} kernel launch(es) a call), plain "
                  f"{st['plain_ms'] * 1e3:.1f} us; pack {st['pack_mb']:.1f} MB -> "
                  f"{st['pack_gb_s']:.0f} GB/s ({100 * st['pack_gb_s'] * 1e9 / HBM_BYTES_S:.1f}% "
                  f"of 3.35 TB/s)", flush=True)
            if not ok:
                raise RuntimeError(f"K2 W{wbits} pos={pos}: error above its bound")
            if st["kernel_launches_per_call"] > 2:
                raise RuntimeError(f"K2 W{wbits} pos={pos}: {st['kernel_launches_per_call']} "
                                   f"kernels a decode step")
            res[(wbits, pos)] = st
        del ck, cv, kvs
        res[(wbits, "batch")] = check_decode_layer_rows(fp, dims, eps, res[(wbits, 600)],
                                                        own_generator(dev, wbits), dev)
        del fp
    return res


def check_decode_layer_rows(fp, dims, eps, one_row, gen, dev):
    """K2 with four rows at ``BATCH_POSITIONS`` (each its own RoPE angles,
    validity and self column; the last row wrapped) against the twin, within
    the one-row bound and with the exactly-equal share of each output; each
    row must equal the kernel's own one-row step bit for bit."""
    import torch
    from mars5_tts_torch.ops.kernels import decode_layer as D

    b = len(BATCH_POSITIONS)
    shape = (dims.n_layers, b, dims.window, dims.dim)
    (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.randn(shape, generator=gen, device=dev) * 0.1)
                          for _ in range(2))
    kvs = torch.stack([ks, vs], dim=2).contiguous()
    x = fp["embed"][torch.tensor(BATCH_POSITIONS, device=dev) % fp["embed"].shape[0]].to(
        torch.bfloat16)
    args = (fp, x, list(BATCH_POSITIONS), ck, cv, kvs)
    got = D.fused_decode_layers(*args, dims=dims, norm_eps=eps)
    want = D.fused_step_ref(*args, dims=dims, norm_eps=eps)
    torch.cuda.synchronize()
    st = {"max_abs_err": 0.0, "positions": list(BATCH_POSITIONS), "exact": {}}
    ok = True
    for name, a, w in zip(("h", "k_new", "v_new"), got, want):
        o, s1 = fused_bound_f32(a, w)
        ok &= o
        st["max_abs_err"] = max(st["max_abs_err"], s1["max_abs_err"])
        st["exact"][name] = s1["exact_frac"]
    rows_equal = all(
        torch.equal(D.fused_decode_layers(fp, x[i:i + 1], p, ck[:, i].contiguous(),
                                          cv[:, i].contiguous(), kvs[:, i].contiguous(),
                                          dims=dims, norm_eps=eps)[0], got[0][i:i + 1])
        for i, p in enumerate(BATCH_POSITIONS))
    nbytes = pack_bytes(fp)
    st.update(ms=cuda_ms(lambda: D.fused_decode_layers(*args, dims=dims, norm_eps=eps), n=50),
              plain_ms=cuda_ms(lambda: D.fused_step_ref(*args, dims=dims, norm_eps=eps), n=3,
                               warmup=1),
              device_ms=device_ms(lambda: D.fused_decode_layers(*args, dims=dims,
                                                                norm_eps=eps)))
    one_args = (fp, x[:1], BATCH_POSITIONS[0], ck[:, 0].contiguous(), cv[:, 0].contiguous(),
                kvs[:, 0].contiguous())
    one_device_ms = st["one_row_device_ms"] = device_ms(
        lambda: D.fused_decode_layers(*one_args, dims=dims, norm_eps=eps))
    ring = dims.n_layers * sum(min(p, dims.window) for p in BATCH_POSITIONS) * (2 * dims.dim + 8)
    st["bound_ms"], st["bound_by"] = bound(
        nbytes + ring, int8=2 * b * nbytes * (2 if dims.wbits == 4 else 1))
    print(f"K2 W{dims.wbits} {b} rows at {BATCH_POSITIONS}: max_abs_err={st['max_abs_err']:.3e} "
          f"exactly equal h/k_new/v_new {st['exact']['h']:.4f}/{st['exact']['k_new']:.4f}/"
          f"{st['exact']['v_new']:.4f}; bound=fused_eq without the exact fraction (f32) and "
          f"each row bitwise equal to its one-row kernel step: within={ok}, rows "
          f"equal={rows_equal} | kernel {st['ms'] * 1e3:.1f} us ({st['ms'] / one_row['ms']:.2f}x "
          f"the one-row step at pos 600 in this call), plain {st['plain_ms'] * 1e3:.1f} us, "
          f"roofline {st['bound_ms'] * 1e3:.1f} us ({st['bound_by']}); device time of its "
          f"kernels (device_ms): {fmt_us(st['device_ms'])}, row 0 alone "
          f"{fmt_us(one_device_ms)}", flush=True)
    if not (ok and rows_equal):
        raise RuntimeError(f"K2 W{dims.wbits} {b} rows: error above its bound")
    return st


def check_head4(ar, gen, dev):
    """K8 at 1536 -> 24,000 on the model's own head against its twin: the int32
    sums are exact and the epilogue the same ops, bound 1e-5 x peak."""
    import torch
    from mars5_tts_torch.ops.kernels import head4 as H

    wp, ws = H.pack_head4(ar.ar.output.weight)
    x = torch.randn((1, ar.cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    n = ar.cfg.n_vocab
    got = H.head4_logits(x, wp, ws, n_vocab=n)
    want = H.head4_logits_ref(x, wp, ws, n_vocab=n)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    run1 = lambda: H.head4_logits(x, wp, ws, n_vocab=n)    # noqa: E731
    st = {"max_abs_err": err, "exact": bool(torch.equal(got, want)),
          "ms": cuda_ms(run1, n=50),
          "plain_ms": cuda_ms(lambda: H.head4_logits_ref(x, wp, ws, n_vocab=n), n=20),
          "host_ms": host_ms(run1), "kernel_launches_per_call": kernel_launches_per_call(H, run1),
          "slab_plan": H.slab_plan(wp.shape[0], x.shape[1], 1)}
    nbytes = wp.numel() + ws.numel() * 4
    st["bound_ms"], st["bound_by"] = bound(nbytes + x.numel() * 2 + n * 4, int8=2 * n * x.shape[1])
    print(f"K8 head4 (1, {ar.cfg.dim}) -> {n}: max_abs_err={err:.3e} (bitwise equal: "
          f"{st['exact']}) bound=1e-5 x peak ({1e-5 * peak:.3e}) within={err <= 1e-5 * peak} | "
          f"kernel {st['ms'] * 1e3:.1f} us (wrapper host {st['host_ms'] * 1e3:.1f} us, "
          f"{st['kernel_launches_per_call']} kernel launch(es) a call; slab plan (rows a block, "
          f"grid, stages, smem) {st['slab_plan']}), plain {st['plain_ms'] * 1e3:.1f} us; "
          f"{nbytes / 1e6:.1f} MB -> {nbytes / (st['ms'] * 1e-3) / 1e9:.0f} GB/s", flush=True)
    if not err <= 1e-5 * peak:
        raise RuntimeError("K8: error above its bound")
    # four rows: one pass over the head for all of them, bitwise equal to the twin
    xb = torch.randn((len(BATCH_POSITIONS), ar.cfg.dim), generator=own_generator(dev),
                     device=dev).to(torch.bfloat16)
    gotb = H.head4_logits(xb, wp, ws, n_vocab=n)
    wantb = H.head4_logits_ref(xb, wp, ws, n_vocab=n)
    torch.cuda.synchronize()
    run4 = lambda: H.head4_logits(xb, wp, ws, n_vocab=n)    # noqa: E731
    sb = {"max_abs_err": (gotb - wantb).abs().max().item(), "exact": bool(torch.equal(gotb, wantb)),
          "ms": cuda_ms(run4, n=50),
          "plain_ms": cuda_ms(lambda: H.head4_logits_ref(xb, wp, ws, n_vocab=n), n=20),
          "device_ms": device_ms(run4), "host_ms": host_ms(run4),
          "kernel_launches_per_call": kernel_launches_per_call(H, run4)}
    st["device_ms"] = device_ms(run1)
    sb["bound_ms"], sb["bound_by"] = bound(nbytes + xb.numel() * 2 + gotb.numel() * 4,
                                           int8=2 * n * xb.numel())
    st["batch"] = sb
    print(f"K8 head4 {tuple(xb.shape)} -> {n}: max_abs_err={sb['max_abs_err']:.3e} bound=bitwise "
          f"equal within={sb['exact']} | kernel {sb['ms'] * 1e3:.1f} us ({sb['ms'] / st['ms']:.2f}x "
          f"the one-row call), plain {sb['plain_ms'] * 1e3:.1f} us, roofline "
          f"{sb['bound_ms'] * 1e3:.1f} us ({sb['bound_by']}); device time of the wrapper's "
          f"kernels (device_ms): {fmt_us(sb['device_ms'])}, one row {fmt_us(st['device_ms'])}; "
          f"wrapper host {sb['host_ms'] * 1e3:.1f} us, {sb['kernel_launches_per_call']} kernel "
          f"launch(es) a call", flush=True)
    if not sb["exact"]:
        raise RuntimeError("K8 four rows: not bitwise equal to the twin")
    if st["kernel_launches_per_call"] != 1 or sb["kernel_launches_per_call"] != 1:
        raise RuntimeError("K8: not one kernel launch a call")
    st["max_abs_err"] = max(err, sb["max_abs_err"])
    return st


def check_decode_attention(ar_cfg, dev, heads=None, cases=K7_CASES, seed=7, window=None):
    """K7 at the bf16 AR's decode shapes (its heads, or ``heads``: a
    tensor-parallel rank's, over a window-2001 bf16 ring, or ``window``
    slots, the self column):
    each case of ``cases`` against the twin
    within one bf16 ulp (``one_ulp``), with the exactly-equal share. The
    library yardstick is ``scaled_dot_product_attention`` over the ring with
    the self column concatenated and a boolean mask, the concatenation made
    beforehand; it reads every slot. The bound counts the valid slots' K and
    V rows. The kernel gets the positions' host bound (``max_pos``) as the AR
    passes it, which sizes its clusters. Beside the CUDA-event times (the
    wrapper's host time included), the device time (``device_ms``) of the
    kernel and of the library call, and the wrapper's host time
    (``host_ms``)."""
    import torch
    import torch.nn.functional as Fn
    from mars5_tts_torch.ops.kernels import decode_attention as A

    gen = own_generator(dev, seed)
    h, d = heads or ar_cfg.n_kv_heads, ar_cfg.head_dim
    w = window or min(ar_cfg.sliding_window, AR_MAX_LEN + 1)
    res = {}
    for positions in cases:
        b = len(positions)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q, kn, vn = rnd(b, h, d), rnd(b, h, d), rnd(b, h, d)
        ck, cv = rnd(b, w, h, d), rnd(b, w, h, d)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        args = (q, ck, cv, pos, kn, vn)
        top = max(positions)            # the host bound the AR passes, sizing the cluster
        n0 = A.launch_count
        got = A.decode_attention(*args, max_pos=top)
        want = A.decode_attention_ref(*args)
        torch.cuda.synchronize()
        if A.launch_count != n0 + 1:
            raise RuntimeError("K7: the wrapper did not count its launch")
        diff = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got).all()) and bool((diff <= A.one_ulp(got, want)).all())
        valid = A.ring_valid(pos, w, True)
        kk = torch.cat([ck, kn[:, None]], 1).transpose(1, 2).contiguous()   # (B, H, W + 1, D)
        vv = torch.cat([cv, vn[:, None]], 1).transpose(1, 2).contiguous()
        mask = torch.cat([valid, torch.ones((b, 1), dtype=torch.bool, device=dev)], 1)
        mask = mask[:, None, None]
        qq = q[:, :, None].contiguous()
        lib = Fn.scaled_dot_product_attention(qq, kk, vv, mask)[:, :, 0]
        st = {"max_abs_err": diff.max().item(), "exact_frac": (got == want).float().mean().item(),
              "library_max_abs_err": (lib.float() - want.float()).abs().max().item(),
              "cluster": A.launch_args(*args, max_pos=top)[-1],
              "ms": cuda_ms(lambda: A.decode_attention(*args, max_pos=top), n=50),
              "plain_ms": cuda_ms(lambda: A.decode_attention_ref(*args), n=10, warmup=2),
              "library_ms": cuda_ms(lambda: Fn.scaled_dot_product_attention(qq, kk, vv, mask),
                                    n=50),
              "device_ms": device_ms(lambda: A.decode_attention(*args, max_pos=top)),
              "host_ms": host_ms(lambda: A.decode_attention(*args, max_pos=top)),
              "library_device_ms": device_ms(
                  lambda: Fn.scaled_dot_product_attention(qq, kk, vv, mask))}
        slots = int(valid.sum())
        st["bound_ms"], st["bound_by"] = bound(
            nbytes(q, kn, vn, pos, got) + 2 * slots * h * d * ck.element_size(),
            bf16=4 * h * d * (slots + b))
        print(f"K7 decode_attention ({b}, {h}, {d}) over ({b}, {w}, {h}, {d}) bf16, self column, "
              f"positions {positions}: max_abs_err={st['max_abs_err']:.3e} exact="
              f"{st['exact_frac']:.4f} bound=1 bf16 ulp within={ok} | kernel "
              f"{st['ms'] * 1e3:.1f} us ({st['cluster']} CTAs a head and row), plain "
              f"{st['plain_ms'] * 1e3:.1f} us, sdpa {st['library_ms'] * 1e3:.1f} us (max diff "
              f"to the twin {st['library_max_abs_err']:.3e}), roofline "
              f"{st['bound_ms'] * 1e3:.2f} us ({st['bound_by']}, {slots} valid slots); device "
              f"time (device_ms): kernel {fmt_us(st['device_ms'])}, sdpa "
              f"{fmt_us(st['library_device_ms'])}; the wrapper's host time "
              f"{st['host_ms'] * 1e3:.1f} us", flush=True)
        if not ok:
            raise RuntimeError(f"K7 positions {positions}: error above its bound")
        res[positions] = st
    return res


def check_mega(dec, dev):
    """K9 on the int8 NAR decoder (16 x 1024, F 3072) at the smoke request's
    shape, both key-padding masks on, its inputs from a generator of its own
    (no earlier check moves them). Each layer alone, teacher-forced: layer
    i's one-layer pack runs on the kernel's own output of layer i - 1, and so
    does the twin, each layer within the JAX kernel tests' fused bound; the
    per-layer errors do not compound, and every layer's offsets into the
    pack and its scale, bias and LN vectors are checked. The exactly-equal
    share of their bf16 outputs is reported (>= 98% expected). Then all
    sixteen in one call, its mean error below 8e-3 x max|twin|
    (tests/test_nar_mega.py, tests/test_torch_nar_mega.py); its max error is
    printed, not gated: over sixteen layers the attention's f32 dots part
    kernel and twin by flips that compound with the inputs."""
    import dataclasses

    import torch
    from mars5_tts_torch.ops.kernels import nar_mega as M

    gen = own_generator(dev, 9)
    mp = M.build_mega_pack(dec)
    d = mp.dims
    x = torch.randn((2, MEGA_L, DIM), generator=gen, device=dev).to(torch.bfloat16)
    mem = torch.randn((2, MEGA_LK, DIM), generator=gen, device=dev).to(torch.bfloat16)
    tm = torch.zeros((2, MEGA_L), dtype=torch.bool, device=dev)
    tm[-1, MEGA_L - MEGA_L // 6:] = True
    mm = torch.zeros((2, MEGA_LK), dtype=torch.bool, device=dev)
    mm[-1, MEGA_LK - 5:] = True

    def layer(i):
        return M.MegaPack(dataclasses.replace(d, n_layers=1), mp.pack[i:i + 1],
                          mp.svec[i:i + 1], mp.bvec[i:i + 1], mp.lnvec[i:i + 1])

    per_layer, ok_layers, h = [], True, x
    for i in range(d.n_layers):
        li = layer(i)
        got_i = M.mega_decoder_stack(li, h, mem, tm, mm)
        ok_i, st_i = fused_bound(got_i, M.mega_decoder_stack_ref(li, h, mem, tm, mm))
        ok_layers &= ok_i
        per_layer.append(st_i)
        h = got_i
    one = layer(0)
    st1 = per_layer[0]
    # layer 0 with two of its three residual branches zeroed: which segment's
    # sums part kernel and twin
    segments = {}
    for seg, off in (("ffn only", (1, 4)), ("self-attention only", (4, 6)),
                     ("cross-attention only", (1, 6))):
        z = M.MegaPack(one.dims, one.pack.clone(), one.svec, one.bvec.clone(), one.lnvec)
        for c in off:
            z.weight(0, c).zero_()
            z.bias(0, c).zero_()
        g, w = M.mega_decoder_stack(z, x, mem, tm, mm), M.mega_decoder_stack_ref(z, x, mem, tm, mm)
        segments[seg] = (g == w).float().mean().item()
    st1["segments_exact"] = segments
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    want = M.mega_decoder_stack_ref(mp, x, mem, tm, mm)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    peak = want.float().abs().max().item()
    ok = bool(torch.isfinite(got).all()) and diff.mean().item() <= 8e-3 * peak
    worst = max(per_layer, key=lambda st: st["max_abs_err"] / max(st["peak"], 1.0))
    run = lambda: M.mega_decoder_stack(mp, x, mem, tm, mm)    # noqa: E731
    st = {"max_abs_err": max(p["max_abs_err"] for p in per_layer),
          "stack_max_abs_err": diff.max().item(), "stack_mean_abs_err": diff.mean().item(),
          "stack_exact_frac": (got == want).float().mean().item(), "stack_peak": peak,
          "layers": per_layer,
          "plan": dict(zip(M.SITES, M.mega_plan(d, 2 * MEGA_L, 2 * MEGA_LK, sm_count(dev)))),
          **mega_times(M, run, lambda: M.mega_decoder_stack_ref(mp, x, mem, tm, mm))}
    st["bound_ms"], st["bound_by"] = mega_bound(mp, x, mem, tm, mm, got)
    # the bench's rows before the profiler runs (it slows a process's later launches)
    st["cases"] = {f"(2, {MEGA_BENCH_L})": check_mega_bench(M, mp, dev)}
    st["phase_ms"] = mega_phases(run, d.n_layers)
    exact = [p["exact_frac"] for p in per_layer]
    D, F = d.dim, d.hidden
    print(f"K9 mega_decoder_stack (2, {MEGA_L}, {D}) over memory (2, {MEGA_LK}, {D}), "
          f"{d.n_layers} x (F {F}), masks on: each layer alone on the kernel's output of the "
          f"layer before, bound=fused_eq (0.02 x peak, >95% exact, mean < 2e-3 x peak) "
          f"within={ok_layers}: max_abs_err per layer "
          + " ".join(f"{p['max_abs_err']:.2e}" for p in per_layer)
          + f" (worst relative to its peak: {worst['max_abs_err']:.3e} of {worst['peak']:.3f}), "
          f"exactly equal {min(exact):.5f}-{max(exact):.5f}; {d.n_layers} layers in one call "
          f"max_abs_err={st['stack_max_abs_err']:.3e} (printed, not gated) mean_abs_err="
          f"{st['stack_mean_abs_err']:.3e} (peak {peak:.3f}) exact={st['stack_exact_frac']:.4f} "
          f"bound=mean <= 8e-3 x peak within={ok} | " + mega_times_txt(st)
          + f"; site plan (tile_b, grid) {st['plan']}; pack {mp.pack.numel() / 1e6:.1f} MB",
          flush=True)
    print("K9 layer 0, exactly-equal share with two residual branches zeroed: "
          + json.dumps(st1["segments_exact"]) + "; device time by phase over one call "
          "(torch.profiler, ms): " + json.dumps(st["phase_ms"]), flush=True)
    if not (ok_layers and ok):
        raise RuntimeError("K9: error above its bound")
    if st["kernel_launches_per_call"] != M.kernels_per_call(d.n_layers):
        raise RuntimeError(f"K9: {st['kernel_launches_per_call']} kernels a call, expected "
                           f"{M.kernels_per_call(d.n_layers)}")
    return st


def mega_times(M, run, twin):
    """K9's CUDA-event, plain-twin, device and host ms a call, and its kernel
    launches a call by the C entry's count. device_ms and host_ms queue 3
    calls (723 launches at 16 layers) to stay inside the launch queue."""
    return {"ms": cuda_ms(run, n=10, warmup=2), "plain_ms": cuda_ms(twin, n=3, warmup=1),
            "device_ms": device_ms(run, n=3), "host_ms": host_ms(run, n=3, warmup=1),
            "kernel_launches_per_call": kernel_launches_per_call(M, run)}


def mega_times_txt(st):
    return (f"kernel {st['ms']:.3f} ms (device {fmt_us(st['device_ms'])}, wrapper host "
            f"{st['host_ms']:.3f} ms, {st['kernel_launches_per_call']} kernel launches from one "
            f"C call), plain {st['plain_ms']:.3f} ms, roofline {st['bound_ms']:.3f} ms "
            f"({st['bound_by']})")


def mega_bound(mp, x, mem, tm, mm, out):
    """K9's bound: its int8 GEMM operations, the bf16 attention's (one pass
    over the valid keys, as the twin's) and its bytes."""
    d = mp.dims
    b, l, D = x.shape
    rows, mk, F = b * l, b * mem.shape[1], d.hidden
    int8_ops = d.n_layers * (2 * rows * (6 * D * D + 3 * F * D) + 2 * mk * 2 * D * D)
    flops = d.n_layers * 4 * d.nhead * l * d.head_dim * (int((~tm).sum()) + int((~mm).sum()))
    return bound(nbytes(x, mem, tm, mm, mp.pack, mp.svec, mp.bvec, mp.lnvec, out), int8=int8_ops,
                 bf16=flops)


def check_mega_bench(M, mp, dev):
    """K9 at the bench's (2, 1200) frames over the smoke's (2, 66) memory,
    masks on: layer 0 alone within the fused bound, the sixteen in one call
    within the stack's mean gate, with its times."""
    import dataclasses

    import torch
    gen = own_generator(dev, 10)
    x = torch.randn((2, MEGA_BENCH_L, DIM), generator=gen, device=dev).to(torch.bfloat16)
    mem = torch.randn((2, MEGA_LK, DIM), generator=gen, device=dev).to(torch.bfloat16)
    tm = torch.zeros((2, MEGA_BENCH_L), dtype=torch.bool, device=dev)
    tm[-1, MEGA_BENCH_L - MEGA_BENCH_L // 6:] = True
    mm = torch.zeros((2, MEGA_LK), dtype=torch.bool, device=dev)
    mm[-1, MEGA_LK - 5:] = True
    one = M.MegaPack(dataclasses.replace(mp.dims, n_layers=1), mp.pack[:1], mp.svec[:1],
                     mp.bvec[:1], mp.lnvec[:1])
    ok1, st1 = fused_bound(M.mega_decoder_stack(one, x, mem, tm, mm),
                           M.mega_decoder_stack_ref(one, x, mem, tm, mm))
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    want = M.mega_decoder_stack_ref(mp, x, mem, tm, mm)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    peak = want.float().abs().max().item()
    ok = ok1 and bool(torch.isfinite(got).all()) and diff.mean().item() <= 8e-3 * peak
    st = {"max_abs_err": st1["max_abs_err"], "layer0_exact_frac": st1["exact_frac"],
          "stack_mean_abs_err": diff.mean().item(), "stack_peak": peak,
          "plan": dict(zip(M.SITES, M.mega_plan(mp.dims, 2 * MEGA_BENCH_L, 2 * MEGA_LK,
                                                sm_count(dev)))),
          **mega_times(M, lambda: M.mega_decoder_stack(mp, x, mem, tm, mm),
                       lambda: M.mega_decoder_stack_ref(mp, x, mem, tm, mm))}
    st["bound_ms"], st["bound_by"] = mega_bound(mp, x, mem, tm, mm, got)
    print(f"K9 mega_decoder_stack (2, {MEGA_BENCH_L}, {DIM}) over memory (2, {MEGA_LK}, {DIM}), "
          f"masks on: layer 0 max_abs_err={st1['max_abs_err']:.3e} exact={st1['exact_frac']:.5f} "
          f"bound=fused_eq; {mp.dims.n_layers} layers mean_abs_err={st['stack_mean_abs_err']:.3e} "
          f"(peak {peak:.3f}) bound=mean <= 8e-3 x peak within={ok} | " + mega_times_txt(st)
          + f"; site plan (tile_b, grid) {st['plan']}", flush=True)
    if not ok:
        raise RuntimeError(f"K9 (2, {MEGA_BENCH_L}): error above its bound")
    if st["kernel_launches_per_call"] != M.kernels_per_call(mp.dims.n_layers):
        raise RuntimeError(f"K9 (2, {MEGA_BENCH_L}): {st['kernel_launches_per_call']} kernels "
                           f"a call")
    return st


MEGA_PHASES = ("ln1 prologue", "qkv", "self-attention", "sa quant", "sa_out", "ln2 prologue",
               "ca_q", "ca_kv", "cross-attention", "ca quant", "ca_out", "ln3 prologue", "WV",
               "u quant", "lin2")


def mega_phases(run, n_layers):
    """Device ms of each K9 phase summed over the layers of one call, from
    the profiler's kernel records in launch order (the memory quant, then
    fifteen a layer), and their sums over the GEMM sites, the prologues and
    the attentions; None when the profiler records no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if any(k in e.name for k in ("w8a8_prologue", "w8a8_wgmma_gemm",
                                                "w8a8_wgmma_swiglu", "mega_attn_kernel"))),
                  key=lambda e: e.time_range.start)
    if len(kern) != 1 + len(MEGA_PHASES) * n_layers:
        return None
    out = {"memory quant": kern[0].time_range.elapsed_us() / 1e3}
    for i, e in enumerate(kern[1:]):
        name = MEGA_PHASES[i % len(MEGA_PHASES)]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    groups = {"GEMM sites": ("qkv", "sa_out", "ca_q", "ca_kv", "ca_out", "WV", "lin2"),
              "prologues": ("memory quant", "ln1 prologue", "sa quant", "ln2 prologue",
                            "ca quant", "ln3 prologue", "u quant"),
              "attention": ("self-attention", "cross-attention")}
    out.update({g: sum(out[k] for k in ks) for g, ks in groups.items()})
    return out


def build_models(dev, torch):
    """The released widths with seeded random weights: a dict of the AR, NAR,
    Encodec, Vocos and the text and speech tokenizers."""
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
    return {"ar": ar, "nar": nar, "encodec": enc, "vocos": voc, "texttok": texttok,
            "speechtok": speechtok}


def counts():
    from mars5_tts_torch.ops.kernels import (decode_attention as A, decode_layer as L,
                                             diffusion_tail as D, head4 as H, mha as K,
                                             moe_decode as E, nar_fused as F, nar_mega as M)
    return {"mha": K.launch_count, "mha_int8": K.int8_launch_count,
            "fused_linear": F.fused_linear_launches, "fused_ffn": F.fused_ffn_launches,
            "fused_linear_grouped": F.fused_linear_grouped_launches,
            "fused_ffn_grouped": F.fused_ffn_grouped_launches,
            "heads_diffusion_tail": D.launch_count,
            "diffusion_tail": D.tail_launch_count, "mega_decoder_stack": M.launch_count,
            "fused_decode_layers": L.launch_count, "head4_logits": H.launch_count,
            "decode_attention": A.launch_count, "moe_decode": E.launch_count}


def reset_counts():
    from mars5_tts_torch.models import ar_decode as AD
    from mars5_tts_torch.ops.kernels import (decode_attention as A, decode_layer as L,
                                             diffusion_tail as D, head4 as H, mha as K,
                                             moe_decode as E, nar_fused as F, nar_mega as M)
    K.reset_launch_count()
    F.reset_launch_counts()
    D.reset_launch_count()
    L.reset_launch_count()
    H.reset_launch_count()
    M.reset_launch_count()
    A.reset_launch_count()
    E.reset_launch_count()
    AD.reset_counts()


AR_RUNS = []


def record_ar(fn):
    """``fn`` (an AR engine, one-row or batched) that also records each
    run's rows as (sequence length, n_generated) and its max_len, for the
    launch and ms-per-step checks."""
    def run(*args, sampling, **kw):
        out = fn(*args, sampling=sampling, **kw)
        rows = out if isinstance(out, list) else [out]
        AR_RUNS.append(([(len(seq), n_gen) for seq, n_gen in rows], sampling.max_len))
        return out
    return run


def decode_steps(rows, max_len):
    """The decode steps of one AR run: a step follows every sampled token but
    the last one of the longest-running row (an EOS, or a token at max_len)."""
    return max(n_gen - (seq_len >= max_len) for seq_len, n_gen in rows)


def check_launches(label, launches, want, steps):
    """Each kernel's launches within ``want`` (name -> (low, high), or a
    function of the decode steps launched giving it: ``steps`` and the step
    a pipelined AR loop launches past an EOS that ends its one run,
    ``ar_decode.discarded_steps`` since ``reset_counts``)."""
    from mars5_tts_torch.models import ar_decode as AD

    if AD.discarded_steps > 1:
        raise RuntimeError(f"{label}: {AD.discarded_steps} AR steps thrown away in one run")
    for name, v in want.items():
        lo, hi = v(steps + AD.discarded_steps) if callable(v) else v
        if not lo <= launches[name] <= hi:
            raise RuntimeError(f"{label}: {name} launched {launches[name]} times, "
                               f"expected {lo}..{hi}")


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
    AR_RUNS.clear()
    t0 = time.perf_counter()
    codes, audio = tts.tts(text, ref, ref_transcript=transcript, cfg=cfg, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    grid = tts.last_grid
    (rows, max_len), = AR_RUNS
    (_, n_gen), = rows
    if not (len(audio) > 0 and np.isfinite(audio).all()):
        raise RuntimeError(f"{label}: tts produced empty or non-finite audio")
    if not (int(grid.min()) >= 0 and int(grid.max()) <= 1024):
        raise RuntimeError(f"{label}: grid codes outside [0, 1024]")
    check_launches(label, launches, want, decode_steps(rows, max_len))
    timing = tts.last_timing
    ar_ms = 1e3 * timing["stages_s"]["ar_generate"] / max(n_gen, 1)
    rec = {"path": label, "wall_s": wall, "ar_frames": int(len(codes)), "ar_tokens": n_gen,
           "ar_ms_per_token": ar_ms,
           "grid": list(grid.shape), "audio_s": timing["audio_s"], "rtf": timing["rtf"],
           "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "stages_s": {k: round(v, 4) for k, v in timing["stages_s"].items()}}
    print(f"request {label} seed={seed}: {len(codes)} AR frames ({n_gen} tokens, AR stage "
          f"{ar_ms:.2f} ms/token incl. prefill), grid {tuple(grid.shape)}, "
          f"audio {timing['audio_s']:.3f} s, total {timing['total_s']:.3f} s, "
          f"RTF {timing['rtf']:.4f}, launches {json.dumps(launches)}; stages "
          + json.dumps(rec["stages_s"]), flush=True)
    return rec


def serve_batch(tts, label, texts, transcripts, ref_seconds, seed, want):
    """One deep-clone ``tts_batch`` request with the counts at 0 before it:
    one voice a text when ``ref_seconds`` is a list (``transcripts`` then a
    matching list), else one shared voice. Checks each row's audio, the
    grid and the launches as ``serve`` does, against the decode steps of the
    one batched AR run."""
    import numpy as np
    import torch
    from mars5_tts_torch import InferenceConfig

    rng = np.random.default_rng(seed)
    per_row = isinstance(ref_seconds, list)
    secs = ref_seconds if per_row else [ref_seconds]
    voices = {s: (rng.standard_normal(int(s * tts.sr)) * 0.1).astype(np.float32)
              for s in dict.fromkeys(secs)}          # rows of one length share a voice
    refs = [voices[s] for s in secs]
    row_tr = transcripts if per_row else [transcripts] * len(texts)
    n_text = max(len(tts.texttok.encode("<|startoftext|>" + tr + " " + text + "<|endoftext|>",
                                        allowed_special="all"))
                 for tr, text in zip(row_tr, texts))
    cfg = InferenceConfig(generate_max_len_override=n_text + int(max(secs) * 75) + GEN_FRAMES,
                          timesteps=STEPS)
    reset_counts()
    AR_RUNS.clear()
    t0 = time.perf_counter()
    outs = tts.tts_batch(texts, refs if per_row else refs[0], ref_transcript=transcripts,
                         cfg=cfg, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    grid = tts.last_grid
    (rows, max_len), = AR_RUNS
    steps = decode_steps(rows, max_len)
    if len(outs) != len(texts) or not all(len(c) > 0 and len(a) > 0 and np.isfinite(a).all()
                                          for c, a in outs):
        raise RuntimeError(f"{label}: tts_batch produced an empty or non-finite row")
    if not (int(grid.min()) >= 0 and int(grid.max()) <= 1024):
        raise RuntimeError(f"{label}: grid codes outside [0, 1024]")
    check_launches(label, launches, want, steps)
    timing = tts.last_timing
    rec = {"path": label, "wall_s": wall, "rows": len(texts),
           "ar_frames": [int(len(c)) for c, _ in outs], "ar_tokens": [n for _, n in rows],
           "ar_steps": steps, "ar_ms_per_step": 1e3 * timing["stages_s"]["ar_generate"] / (steps + 1),
           "nar_ms_per_step": 1e3 * timing["stages_s"]["nar_diffusion"] / STEPS,
           "grid": list(grid.shape), "audio_s": timing["audio_s"], "rtf": timing["rtf"],
           "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "stages_s": {k: round(v, 4) for k, v in timing["stages_s"].items()}}
    print(f"request {label} seed={seed}: {len(texts)} rows, AR tokens {rec['ar_tokens']} in "
          f"{steps} batched steps ({rec['ar_ms_per_step']:.2f} ms a step incl. prefill), NAR "
          f"{rec['nar_ms_per_step']:.2f} ms a step, grid {tuple(grid.shape)}, audio "
          f"{timing['audio_s']:.3f} s in all, total {timing['total_s']:.3f} s, RTF "
          f"{timing['rtf']:.4f}, launches {json.dumps(launches)}; stages "
          + json.dumps(rec["stages_s"]), flush=True)
    return rec


class phase:
    """Names the phase a failure came from: the exception goes on, after a
    line ``chip_smoke: phase <name> failed: <type>: <message>``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, kind, exc, tb):
        if exc is not None:
            print(f"chip_smoke: phase {self.name} failed: {kind.__name__}: {exc}", flush=True)
        return False


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
    with phase("2 (build)"):
        from mars5_tts_torch.ops.kernels import build, mha as K
        t0 = time.perf_counter()
        libs = build.build_all()
        build_s = time.perf_counter() - t0
        for name, lib in libs.items():
            regs = [ln.strip() for ln in build.build_log.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"build: {lib.name} ({'compiled in %.1f s' % build.build_seconds[name] if name in build.build_seconds else 'already built'}); "
                  + " | ".join(regs), flush=True)
        print(f"build: all libraries in {build_s:.1f} s", flush=True)
        # every GEMM of K3/K4 (kG, the last template argument, 1 or 2: grouped)
        # and K1's int8 kernels: registers and spills, none allowed
        check_ptxas("nar_fused", ("w8a8_wgmma_gemm", "w8a8_wgmma_swiglu"))
        if len(check_ptxas("mha", ("mha_int8_",))) != 3:
            raise RuntimeError("mha: the ptxas log lacks one of the int8 mode's three kernels")

    # -- 3. kernels against plain, on the card
    with phase("3 (kernels against their twins)"):
        gen = torch.Generator(device=dev).manual_seed(1)
        main_res = check_kernel(K, MAIN_SHAPE, True, torch.bfloat16, gen, dev)
        second = check_kernel(K, SECOND_SHAPE, False, torch.bfloat16, gen, dev)
        check_kernel(K, (1, 600, 4, 64), True, torch.float32, gen, dev)
        # the calls the int8 decoder makes: its last layer at the bench geometry,
        # and every layer of the smoke request (strided views of the qkv projection)
        k1_views = [check_kernel(K, (2, 750, 16, 64), True, torch.bfloat16, own_generator(dev, 11),
                                 dev, lk=MAIN_SHAPE[1], q_start=MAIN_SHAPE[1] - 750),
                    check_kernel(K, (2, MEGA_L, 16, 64), True, torch.bfloat16,
                                 own_generator(dev, 12), dev, lk=MEGA_L)]
        w8a8 = check_nar_fused(gen, dev)
        k6, k5 = check_heads_tail(gen, dev)
        models = build_models(dev, torch)
        snap = snapshot_weights(models)       # phase 7's checkpoints, before phase 4 quantizes
        k2 = check_decode_layer(models["ar"], gen, dev)
        k8 = check_head4(models["ar"], gen, dev)
        k7 = check_decode_attention(models["ar"].cfg, dev)
        # a tensor-parallel rank's heads (phase 6 (e)): K7 over its 12 of the
        # AR's 24, K1 on its 8 of the NAR's 16 as strided views of its qkv
        k7_tp = check_decode_attention(models["ar"].cfg, dev, heads=24 // TP,
                                       cases=K7_TP_CASES, seed=32)
        k1_tp = check_kernel(K, K1_TP_SHAPE, True, torch.bfloat16, own_generator(dev, 31), dev,
                             lk=K1_TP_SHAPE[1])
        # and at the shapes phase 6 (e) itself gives them
        k7_tp_run = check_decode_attention(models["ar"].cfg, dev, heads=24 // TP,
                                           cases=K7_TP_RING_CASES, seed=33, window=K7_TP_RING)
        k1_tp_run = {shape: check_kernel(K, shape, True, torch.bfloat16,
                                         own_generator(dev, 34 + i), dev, lk=shape[1])
                     for i, shape in enumerate(K1_TP_RUN_SHAPES)}
        k1_modes = check_k1_modes(dev)
        w8a8_g = check_nar_fused_grouped(dev)
        # a short request (2 x 400 frames), where the plan takes 64-wide tiles for
        # caq, the residual sites and lin2
        w8a8_g_short = check_nar_fused_grouped(dev, SHORT_M)
        # the serving path's new shapes: one batch row (a cond-only step), the
        # greedy last step, a wave of three rows
        k1_one = check_kernel(K, (1, MAIN_SHAPE[1], 16, 64), True, torch.bfloat16,
                              own_generator(dev, 22), dev)
        w8a8_one = check_nar_fused_one_row(dev)
        k6_serving = check_heads_tail_serving(dev)

    # -- 4. main paths, each request with its launch counts from 0
    with phase("4 (main paths)"):
        records, main_launches, path_launches, nar8 = serve_paths(models, dev)
    # -- 5. serving, before anything runs the profiler
    with phase("5 (serving)"):
        serving = serve_serving(models, nar8, records, dev)
    # -- 7. the entry points from files on disk, before the profiler too
    with phase("7 (entry points from files)"):
        entry = entry_points(models, nar8, snap, records, serving)
    del snap
    # -- 8. K10 and the DeepSeek-V2-Lite AR, before the profiler too
    with phase("8 (K10 and the DeepSeek-V2-Lite AR)"):
        dsv_cfg, _ = dsv2lite_config()
        k10 = check_moe_decode(dsv_cfg, dev)
        dsv = serve_dsv2lite(models, nar8, dev)
    with phase("3/5 (K9 and the launch splits after the requests)"):
        k9_one = {f"(1, {n})": check_mega_one_row(nar8.tfm.decoder, dev, n)
                  for n in (MEGA_L, MEGA_BENCH_L)}
        # K9 on the served NAR's own int8 decoder weights
        k9 = check_mega(nar8.tfm.decoder, dev)
        w8a8_split = w8a8_launch_split(w8a8, w8a8_g)
        k1_split = k1_int8_launch_split(k1_modes)
        tile_ab = {m: grouped_tile_ab(res, m) for m, res in ((M_ROWS, w8a8_g),
                                                             (SHORT_M, w8a8_g_short))}
        idle = serving_idle_shares(serving)
    # -- 6. training and data-parallel decoding (the served AR for the decoder;
    # the other models leave the card first)
    with phase("6 (d) (data-parallel decoder)"):
        dp_decode = check_dp_decoder(models, dev)
    with phase("6 (e) (tensor-parallel decoders, two ranks on the card)"):
        tp_decode = check_tp_decoders(smi)
    tp_held = {name: [h[name] for h in tp_decode["held_against_twins_per_rank"]]
               for name in ("mha", "decode_attention")}
    for rec in serving.values():            # the reruns hold the served models
        if isinstance(rec, dict):
            rec.pop("_rerun", None)
    del nar8
    for name in ("nar", "encodec", "vocos"):
        models.pop(name, None)
    with phase("6 (training)"):
        train_phase(models, dev)
    if any(m.split(".")[0] in ("jax", "mars5_tts_tpu") for m in sys.modules):
        raise RuntimeError("the port pulled in jax or the JAX package")

    def row(name, source, replaces, st, launches=None):
        return {"name": name, "route": "cuda", "source": f"mars5_tts_torch/csrc/{source}",
                "replaces": replaces,
                "launches": main_launches[name] if launches is None else launches,
                "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": st.get("library_ms"),
                "entry_launches": {label: rec["launches"][name] for label, rec in entry.items()
                                   if isinstance(rec, dict) and "launches" in rec}}

    k6_worst = max(k6, key=lambda st: st["max_abs_err"])
    k2_main = k2[(4, AR_POSITIONS[0])]

    def w8a8_extra(st, int_mm):
        return {"device_ms": st["device_ms"], "host_ms": st["host_ms"],
                "exact_frac": st["exact_frac"],
                "int_mm_ms": None if int_mm is None else int_mm["ms"],
                "int_mm_device_ms": None if int_mm is None else int_mm["device_ms"]}

    def batched(st):
        keys = ("positions", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "device_ms", "one_row_device_ms", "library_ms", "library_device_ms",
                "host_ms", "cluster", "kernel_launches_per_call")
        return {k: st[k] for k in keys if k in st}
    def pick(st, keys=("ms", "plain_ms", "device_ms", "host_ms", "bound_ms", "bound_by",
                       "max_abs_err", "exact_frac", "kernel_launches_per_call",
                       "stack_mean_abs_err", "plan")):
        return {k: st[k] for k in keys if k in st}
    k1_cross = k1_modes["bf16 cross (2, 725) over 66"]
    k1_int8 = {name: st for name, st in k1_modes.items() if name.startswith("int8")}
    print(json.dumps({"kernels": [
        {**row("mha", "mha.cu", "mars5_tts_tpu/ops/pallas/mha.py:46", main_res),
         "max_abs_err": max(st["max_abs_err"] for st in (main_res, second, *k1_views, k1_cross,
                                                         k1_one, k1_tp, *k1_tp_run.values(),
                                                         *tp_held["mha"])),
         "device_ms": main_res["device_ms"], "host_ms": main_res["host_ms"],
         "encode_us": main_res["encode_us"],
         "library_unmasked_ms": main_res["library_unmasked_ms"],
         "cases": {name: {k: st.get(k) for k in ("ms", "device_ms", "host_ms", "encode_us",
                                                 "library_ms", "bound_ms", "max_abs_err")}
                   for name, st in (("(2, 525) unmasked", second),
                                    ("(2, 750) over 1200 strided", k1_views[0]),
                                    ("(2, 725) strided", k1_views[1]),
                                    ("(2, 725) over 66 cross", k1_cross),
                                    ("(1, 1200) masked", k1_one),
                                    (f"(2, 1200, {K1_TP_SHAPE[2]} heads) masked, a tp={TP} "
                                     "rank's qkv views", k1_tp),
                                    *((f"({b}, {n}, {h} heads) masked, a tp={TP} rank's qkv "
                                       "views (phase 6 (e))", st)
                                      for (b, n, h, _), st in k1_tp_run.items()))},
         "serving_launches": serving["deploy"]["launches"]["mha"],
         "tp_rank_launches": tp_decode["k1_per_rank"],
         "tp_rank_held_against_twin": tp_held["mha"]},
        {**row("mha_int8", "mha.cu", "mars5_tts_tpu/ops/pallas/mha.py:46",
               k1_int8["int8 (2, 1200) masked"], launches=path_launches["mha_int8"]),
         "max_abs_err": max(st["max_abs_err"] for st in k1_int8.values()),
         "cases": {name: {**{k: st[k] for k in ("ms", "plain_ms", "device_ms", "host_ms",
                                                "bound_ms", "bound_by", "max_abs_err",
                                                "max_bound", "sdpa_yardstick_ms",
                                                "kernel_launches_per_call")},
                          "launch_us": k1_split.get(name)}
                   for name, st in k1_int8.items()}},
        {**row("fused_linear_grouped", "nar_fused.cu",
               "mars5_tts_tpu/ops/pallas/nar_fused.py:111", w8a8_g["qkv"],
               launches=path_launches["fused_linear_grouped"]),
         "max_abs_err": max(w8a8_g[v]["max_abs_err"] for v in ("qkv", "caq", "residual")),
         **w8a8_extra(w8a8_g["qkv"], None), "plan": w8a8_g["plan"], "tile_ab_ms": tile_ab,
         "launch_us": w8a8_split.get("K3 grouped qkv"),
         "cases": {v: {**{k: w8a8_g[v][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                       **w8a8_extra(w8a8_g[v], None),
                       "launch_us": w8a8_split.get(f"K3 grouped {v}")}
                   for v in ("caq", "residual")}},
        {**row("fused_ffn_grouped", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:144",
               w8a8_g["ffn"], launches=path_launches["fused_ffn_grouped"]),
         **w8a8_extra(w8a8_g["ffn"], None), "launch_us": w8a8_split.get("K4 grouped ffn")},
        {**row("fused_decode_layers", "decode_layer.cu",
               "mars5_tts_tpu/ops/pallas/decode_layer.py:139", k2_main),
         "max_abs_err": max(st["max_abs_err"] for st in k2.values()),
         **{k: k2_main[k] for k in ("device_ms", "host_ms", "kernel_launches_per_call")},
         "cases": {f"W{wb} pos {pos}": {k: k2[(wb, pos)][k] for k in
                                        ("ms", "device_ms", "host_ms", "bound_ms",
                                         "max_abs_err", "kernel_launches_per_call")}
                   for wb in (4, 8) for pos in AR_POSITIONS},
         "batch4": {f"W{wb}": batched(k2[(wb, "batch")]) for wb in (4, 8)},
         "pool": {**{k: serving["pool"][k] for k in ("rows", "steps", "k2_launches",
                                                     "rows_equal_solo", "pool_tokens_per_s",
                                                     "solo_tokens_per_s")},
                  "idle_share": idle["pool"]["idle_share"]}},
        {**row("fused_linear", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:111",
               w8a8["qkv"]),
         "max_abs_err": max(w8a8[v]["max_abs_err"] for v in ("qkv", "caq", "residual")),
         **w8a8_extra(w8a8["qkv"], w8a8["int_mm"]["qkv"]),
         "launch_us": w8a8_split.get("K3 qkv"),
         "cases": {**{v: {**{k: w8a8[v][k] for k in ("ms", "bound_ms", "max_abs_err")},
                          **w8a8_extra(w8a8[v], w8a8["int_mm"].get(v))}
                      for v in ("caq", "residual")},
                   "qkv (1, 1200)": pick(w8a8_one["qkv"])}},
        {**row("fused_ffn", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:144",
               w8a8["ffn"]), **w8a8_extra(w8a8["ffn"], w8a8["int_mm"]["ffn"]),
         "launch_us": w8a8_split.get("K4 ffn"), "cases": {"(1, 1200)": pick(w8a8_one["ffn"])}},
        {**row("heads_diffusion_tail", "diffusion_tail.cu",
               "mars5_tts_tpu/ops/pallas/diffusion_tail.py:149", k6[-1]),
         "max_abs_err": k6_worst["max_abs_err"],
         **{k: k6[-1][k] for k in ("device_ms", "host_ms", "kernel_launches_per_call")},
         "t0": {k: k6[0][k] for k in ("ms", "device_ms", "host_ms")},
         "max_abs_err_serving": max(st["max_abs_err"] for st in k6_serving.values()),
         "serving": {name: {k: st[k] for k in ("mismatches", "near_ties", "max_abs_err", "ms",
                                               "plain_ms", "device_ms", "bound_ms", "bound_by")}
                     for name, st in k6_serving.items()},
         "serving_launches": {n: serving[n]["launches"]["heads_diffusion_tail"]
                              for n in ("deploy", "deploy_mega")}},
        {**row("head4_logits", "head4.cu", "mars5_tts_tpu/ops/pallas/head4.py:55", k8,
               launches=path_launches["head4_logits"]),
         **{k: k8[k] for k in ("device_ms", "host_ms", "kernel_launches_per_call")},
         "batch4": batched(k8["batch"])},
        {**row("decode_attention", "decode_attention.cu",
               "mars5_tts_tpu/ops/pallas/decode_attention.py:32", k7[K7_CASES[0]],
               launches=path_launches["decode_attention"]),
         "dp_decoder_launches": dp_decode["decode_attention_launches"],
         "tp_rank_launches": tp_decode["k7_per_rank"],
         "tp_rank_held_against_twin": tp_held["decode_attention"],
         "max_abs_err": max(st["max_abs_err"] for st in (*k7.values(), *k7_tp.values(),
                                                         *k7_tp_run.values(),
                                                         *tp_held["decode_attention"])),
         "device_ms": k7[K7_CASES[0]]["device_ms"], "host_ms": k7[K7_CASES[0]]["host_ms"],
         "cases": {**{",".join(map(str, p)): batched(st) for p, st in k7.items()},
                   **{f"{24 // TP} heads " + ",".join(map(str, p)): batched(st)
                      for p, st in k7_tp.items()},
                   **{f"{24 // TP} heads over {K7_TP_RING} slots " + ",".join(map(str, p)):
                      batched(st) for p, st in k7_tp_run.items()}}},
        {**row("diffusion_tail", "diffusion_tail.cu",
               "mars5_tts_tpu/ops/pallas/diffusion_tail.py:41", k5[-1],
               launches=path_launches["diffusion_tail"]),
         "device_ms": k5[-1]["device_ms"], "host_ms": k5[-1]["host_ms"],
         "t0": {k: k5[0][k] for k in ("ms", "device_ms", "host_ms")},
         "serving": {name: {"vs_k6": st["k5_vs_k6"], "vs_twin": st["k5_vs_twin"],
                            "device_ms": st["k5_device_ms"]} for name, st in k6_serving.items()}},
        {**row("mega_decoder_stack", "nar_mega.cu", "mars5_tts_tpu/ops/pallas/nar_mega.py:251",
               k9, launches=path_launches["mega_decoder_stack"]),
         **{k: k9[k] for k in ("device_ms", "host_ms", "kernel_launches_per_call", "phase_ms")},
         "cases": {name: {k: st[k] for k in ("ms", "plain_ms", "device_ms", "host_ms",
                                             "kernel_launches_per_call", "bound_ms", "bound_by",
                                             "max_abs_err", "stack_mean_abs_err")}
                   for name, st in {**k9["cases"], **k9_one}.items()},
         "serving_launches": serving["deploy_mega"]["launches"]["mega_decoder_stack"]},
        {**row("moe_decode", "moe_decode.cu", "none (no TPU counterpart)", k10[1],
               launches=dsv["graphed"]["launches"]["moe_decode"]),
         **{k: k10[1][k] for k in ("device_ms", "host_ms", "share_of_bound", "max_ulps",
                                   "exact_frac", "bound_mb")},
         "launches_per_decode_step": dsv["k10_launches_per_decode_step"],
         "ar_ms_per_token": dsv["graphed"]["ar_ms_per_token"],
         "held_in_request": dsv["eager_held"],
         "cases": {f"{rows} rows": pick(st, ("ms", "plain_ms", "device_ms", "host_ms",
                                             "bound_ms", "bound_by", "max_abs_err", "max_ulps",
                                             "exact_frac", "distinct_experts",
                                             "share_of_bound"))
                   for rows, st in k10.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_paths(models, dev):
    """Phase 4: every path's requests (the bf16 NAR leaves ``models`` once it
    is quantized). Returns (records, the launches of the production requests
    (fused4 AR + int8 NAR) by kernel, the launches of K8, K5, K9 and K7 on
    the requests of their own paths (K7: the bf16 ``tts_batch``), the int8
    NAR)."""
    import torch

    import mars5_tts_torch.pipeline as pipeline
    from mars5_tts_torch import Mars5TTS
    for name in ("ar_generate", "ar_generate_batched"):
        setattr(pipeline, name, record_ar(getattr(pipeline, name)))
    ar, nar = models["ar"], models.pop("nar")
    ar_layers = ar.cfg.n_layers
    common = {k: models[k] for k in ("texttok", "speechtok", "encodec", "vocos")}
    layers = nar.cfg.dec_layers
    # the default routes never take K1's int8 mode or the grouped K3/K4
    no_modes = {"mha_int8": (0, 0), "fused_linear_grouped": (0, 0), "fused_ffn_grouped": (0, 0)}
    k1_only = {"mha": (layers * STEPS, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
               "heads_diffusion_tail": (0, 0), "diffusion_tail": (0, 0),
               "mega_decoder_stack": (0, 0), **no_modes}
    int8 = {"mha": (layers * STEPS, 10 ** 9),
            "fused_linear": (2 * layers * STEPS, 2 * layers * STEPS),
            "fused_ffn": (layers * STEPS, layers * STEPS),
            "heads_diffusion_tail": (STEPS, STEPS), "diffusion_tail": (0, 0),
            "mega_decoder_stack": (0, 0), **no_modes}
    # K9 in place of the decoder's K1, K3 and K4; K5 in place of K6
    mega = {**int8, "mha": (0, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
            "mega_decoder_stack": (STEPS, STEPS)}
    split = {**int8, "heads_diffusion_tail": (0, 0), "diffusion_tail": (STEPS, STEPS)}
    # K7 once a layer a decode step on the bf16 AR, never on the quantized one
    bf16_ar = {"fused_decode_layers": (0, 0), "head4_logits": (0, 0),
               "decode_attention": lambda n: (ar_layers * n, ar_layers * n)}
    fused_ar = {"fused_decode_layers": lambda n: (n, n), "head4_logits": (0, 0),
                "decode_attention": (0, 0)}
    head4_ar = {**fused_ar, "head4_logits": lambda n: (n, n)}
    first = ("The quick brown fox jumps over the lazy dog.", "A reference voice.", 11)
    second_req = ("Hello from the port of the speech model.", "Another sample here.", 12)
    batch_texts = (first[0], second_req[0], "A third line, read in the first voice.")
    torch.cuda.reset_peak_memory_stats(dev)
    records = [serve(Mars5TTS.from_params(ar, nar, **common), "bf16 AR + bf16 NAR", *first,
                     {**k1_only, **bf16_ar})]
    t0 = time.perf_counter()
    nar8 = Mars5TTS.from_params(ar, nar, nar_backend="int8", **common).codecnar
    torch.cuda.synchronize()
    print(f"quantize_nar: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    nar8g = Mars5TTS.from_params(ar, nar, nar_backend="int8", nar_gsize=GSIZE,
                                 **common).codecnar
    torch.cuda.synchronize()
    print(f"quantize_nar(w_gsize={GSIZE}): {time.perf_counter() - t0:.2f} s", flush=True)
    del nar
    torch.cuda.reset_peak_memory_stats(dev)
    records.append(serve(Mars5TTS.from_params(ar, nar8, nar_backend="int8", **common),
                         "bf16 AR + int8 NAR", *first, {**int8, **bf16_ar}))
    prod = Mars5TTS.from_params(ar, nar8, ar_backend="fused4", nar_backend="int8", **common)
    main_launches = {}
    for label, req in (("fused4 AR + int8 NAR (warm-up, builds the pack)", second_req),
                       ("fused4 AR + int8 NAR", first)):
        torch.cuda.reset_peak_memory_stats(dev)
        records.append(serve(prod, label, *req, {**int8, **fused_ar}))
        for k, v in records[-1]["launches"].items():
            main_launches[k] = main_launches.get(k, 0) + v
    # the batched path on the same pipeline: the pack is shared, dims for 3 rows
    torch.cuda.reset_peak_memory_stats(dev)
    batch_records = [serve_batch(
        prod, "tts_batch x3, two voices (7 s, 5 s, 7 s): fused4 AR + int8 NAR", batch_texts,
        [first[1], second_req[1], first[1]], [REF_SECONDS, 5.0, REF_SECONDS], 13,
        {**int8, **fused_ar})]
    del prod
    for label, kw, want_ar in (("fused AR + int8 NAR", dict(ar_backend="fused"), fused_ar),
                               ("fused4 AR head4 + int8 NAR",
                                dict(ar_backend="fused4", head4=True), head4_ar)):
        torch.cuda.reset_peak_memory_stats(dev)
        tts = Mars5TTS.from_params(ar, nar8, nar_backend="int8", **kw, **common)
        records.append(serve(tts, label, *first, {**int8, **want_ar}))
        del tts
    path_launches = {"head4_logits": records[-1]["launches"]["head4_logits"]}
    default = records[3]                     # fused4 + int8, the same request
    for label, kw, want_nar, name in (
            ("fused4 AR + int8 NAR, nar_mega=True", dict(nar_mega=True), mega,
             "mega_decoder_stack"),
            ("fused4 AR + int8 NAR, nar_tail='split'", dict(nar_tail="split"), split,
             "diffusion_tail")):
        torch.cuda.reset_peak_memory_stats(dev)
        tts = Mars5TTS.from_params(ar, nar8, ar_backend="fused4", nar_backend="int8", **kw,
                                   **common)
        rec = serve(tts, label, *first, {**want_nar, **fused_ar})
        del tts
        records.append(rec)
        path_launches[name] = rec["launches"][name]
        if name == "mega_decoder_stack":     # K1 is left for the speaker encoders only
            k1 = default["launches"]["mha"] - layers * STEPS
            if rec["launches"]["mha"] != k1:
                raise RuntimeError(f"{label}: K1 launched {rec['launches']['mha']} times, "
                                   f"expected {k1}")
        nar_ms = [1e3 * r["stages_s"]["nar_diffusion"] / STEPS for r in (rec, default)]
        print(f"{label}: NAR {nar_ms[0]:.2f} ms a step against {nar_ms[1]:.2f} for the default "
              f"int8 route in this call; stages {json.dumps(rec['stages_s'])} against "
              f"{json.dumps(default['stages_s'])}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    tts = Mars5TTS.from_params(ar, nar8, nar_backend="int8", **common)
    batch_records.append(serve_batch(
        tts, "tts_batch x2, one voice (7 s): bf16 AR + int8 NAR", batch_texts[:2], first[1],
        REF_SECONDS, 14, {**int8, **bf16_ar}))
    del tts
    path_launches["decode_attention"] = batch_records[-1]["launches"]["decode_attention"]
    # the int8 NAR's other routes: (a) per-K-group scales through grouped K3 /
    # K4, (b) the unfused layer with K1's int8 mode on both attentions
    sites3 = 2 * layers * STEPS
    grouped = {**int8, "fused_linear_grouped": (sites3, sites3),
               "fused_ffn_grouped": (layers * STEPS, layers * STEPS), "mha_int8": (0, 0)}
    unfused = {**int8, "fused_linear": (0, 0), "fused_ffn": (0, 0),
               "mha_int8": (2 * layers * STEPS, 2 * layers * STEPS)}
    for label, nar_q, kw, want_nar, names in (
            (f"fused4 AR + int8 NAR, nar_gsize={GSIZE}", nar8g, dict(nar_gsize=GSIZE), grouped,
             ("fused_linear_grouped", "fused_ffn_grouped")),
            ("fused4 AR + int8 NAR, nar_fused=False, nar_qattn, nar_cross_k1", nar8,
             dict(nar_fused=False, nar_qattn=True, nar_cross_k1=True), unfused, ("mha_int8",))):
        torch.cuda.reset_peak_memory_stats(dev)
        tts = Mars5TTS.from_params(ar, nar_q, ar_backend="fused4", nar_backend="int8", **kw,
                                   **common)
        rec = serve(tts, label, *first, {**want_nar, **fused_ar})
        del tts
        records.append(rec)
        path_launches.update({n: rec["launches"][n] for n in names})
        nar_ms = [1e3 * r["stages_s"]["nar_diffusion"] / STEPS for r in (rec, default)]
        print(f"{label}: NAR {nar_ms[0]:.2f} ms a step against {nar_ms[1]:.2f} for the default "
              f"int8 route in this call", flush=True)
    del nar8g
    print(json.dumps({"requests": records + batch_records}), flush=True)
    bf16_ms = records[1]["ar_ms_per_token"]
    print("AR stage ms/token (same call, incl. prefill): " + ", ".join(
        f"{r['path']}: {r['ar_ms_per_token']:.2f}" for r in records)
        + f"; fused4 / bf16 AR = {records[3]['ar_ms_per_token'] / bf16_ms:.3f}; tts_batch AR "
        "ms a batched step: " + ", ".join(
            f"{r['path']}: {r['ar_ms_per_step']:.2f}" for r in batch_records), flush=True)
    return records + batch_records, main_launches, path_launches, nar8


# ---------------------------------------------------------------- 5. serving

DEPLOY = dict(ar_backend="fused4", nar_backend="int8", guidance_interval=(0.0, 0.5),
              nar_gen_bucket=64, nar_text_bucket=32)     # deploy/predict.py's defaults
POOL_ROWS, POOL_CHUNK, POOL_BUCKETS = 4, 64, (64, 576)
WAVE_T = 8     # the injected-stream wave check's depth (see check_waves)
STREAM = dict(seg_frames=192, ctx_frames=192, vocode_margin=32)    # stream_tts's segments


def reference_voice(tts, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(REF_SECONDS * tts.sr)) * 0.1).astype(np.float32)


def request_prompt(tts, text, transcript, codes, deep):
    """The AR prompt of a request as ``Mars5TTS._synthesize_codes`` builds it
    from the reference's (1, n_q, S) ``codes``: (prompt ids, the text ids the
    NAR reads, the index of the first parsed codec token)."""
    import numpy as np
    n_text = len(tts.texttok.vocab)
    if deep:
        tokens = tts.texttok.encode("<|startoftext|>" + transcript + " " + text
                                    + "<|endoftext|>", allowed_special="all")
        speech = [p + n_text for p in tts.speechtok.encode(
            " ".join(str(t) for t in codes[0, 0].tolist()))]
    else:
        tokens = tts.texttok.encode("<|startoftext|>" + text + "<|endoftext|>",
                                    allowed_special="all")
        speech = []
    prompt = np.asarray(tokens + speech, np.int64)
    return prompt, np.asarray(tokens, np.int64), len(prompt) - len(speech) + 1


def parse_l0(tts, tokens, first_codec_idx):
    """The L0 codes of an AR sequence, as ``_synthesize_codes`` parses them."""
    import numpy as np
    out = np.clip(tokens - len(tts.texttok.vocab), 0, None)[first_codec_idx:]
    return np.asarray([s for s in tts.speechtok.decode_int(out.tolist()) if isinstance(s, int)],
                      np.int64)


def count_tail_rows(engine):
    """Wrap the engine's K6 entry to record, a call, whether it ran the CFG
    rows (rows == 2 bs) or the cond rows alone; returns (the record, undo)."""
    calls = []
    k6 = engine.heads_diffusion_tail

    def run(x8, xs, folded, u0, *a, **k):
        calls.append(x8.shape[0] == 2 * u0.shape[0])
        return k6(x8, xs, folded, u0, *a, **k)
    engine.heads_diffusion_tail = run
    return calls, lambda: setattr(engine, "heads_diffusion_tail", k6)


def serve_deploy(tts, label, req, want, default):
    """One deploy-configuration request (guidance interval and buckets) on
    ``tts``: ``serve``'s checks, K6's 200 calls split 100 CFG / 100
    cond-only, and the NAR ms a step beside ``default``'s (phase 4's request
    on the same route without the interval and buckets, in this call)."""
    from mars5_tts_torch.diffusion import engine
    rows, undo = count_tail_rows(engine)
    try:
        rec = serve(tts, label, *req, want)
    finally:
        undo()
    cfg_steps = sum(rows)
    if (cfg_steps, len(rows) - cfg_steps) != (STEPS // 2, STEPS // 2):
        raise RuntimeError(f"{label}: K6 ran {cfg_steps} CFG and {len(rows) - cfg_steps} "
                           f"cond-only calls, expected {STEPS // 2} each")
    rec["k6_cfg_calls"], rec["k6_cond_only_calls"] = cfg_steps, len(rows) - cfg_steps
    rec["nar_ms_per_step"] = 1e3 * rec["stages_s"]["nar_diffusion"] / STEPS
    default_ms = 1e3 * default["stages_s"]["nar_diffusion"] / STEPS
    print(f"{label}: NAR {rec['nar_ms_per_step']:.2f} ms a step ({cfg_steps} CFG + "
          f"{len(rows) - cfg_steps} cond-only K6 calls) against {default_ms:.2f} for "
          f"'{default['path']}' (CFG every step, no buckets) in this call", flush=True)
    rec["nar_ms_per_step_without"] = default_ms
    return rec


def check_stream(tts, req, seed):
    """``stream_tts`` on the deploy model: at least two segments, the
    concatenated PCM one vocode of the emitted grid within atol 2e-5, rtol
    1e-4, and the time to the first chunk."""
    import numpy as np
    import torch
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.serving import stream_tts

    text, transcript, _ = req
    ref = reference_voice(tts, seed)
    n_text = len(tts.texttok.encode("<|startoftext|>" + transcript + " " + text
                                    + "<|endoftext|>", allowed_special="all"))
    cfg = InferenceConfig(generate_max_len_override=n_text + int(REF_SECONDS * 75) + GEN_FRAMES,
                          timesteps=STEPS)
    reset_counts()
    t0 = time.perf_counter()
    chunks, first_s = [], None
    for ch in stream_tts(tts, text, ref, ref_transcript=transcript, cfg=cfg, seed=seed,
                         **STREAM):
        torch.cuda.synchronize()
        if first_s is None:
            first_s = time.perf_counter() - t0
        chunks.append(ch)
    wall = time.perf_counter() - t0
    launches = counts()
    grid = np.concatenate([c.grid for c in chunks])
    pcm = np.concatenate([c.pcm for c in chunks])
    full = tts.vocode(grid)[: len(grid) * tts.vocos.cfg.hop_length]
    diff = np.abs(pcm - full) if pcm.shape == full.shape else None
    ok = diff is not None and bool(np.all(diff <= 2e-5 + 1e-4 * np.abs(full)))
    rec = {"segments": len(chunks), "frames": int(len(grid)), "first_chunk_s": first_s,
           "wall_s": wall, "audio_s": len(pcm) / tts.sr,
           "pcm_max_abs_err": None if diff is None else float(diff.max()),
           "launches": launches}
    print(f"stream_tts (deploy model, {STREAM}): {len(chunks)} segments, "
          f"{len(grid)} frames, first chunk after {first_s:.3f} s of {wall:.3f} s, "
          f"{rec['audio_s']:.3f} s of audio; streamed PCM against one vocode of the emitted "
          f"grid max_abs_err={rec['pcm_max_abs_err']} bound=atol 2e-5 + rtol 1e-4 within={ok}; "
          f"launches {json.dumps(launches)}", flush=True)
    if len(chunks) < 2 or not ok or not np.isfinite(pcm).all():
        raise RuntimeError("stream_tts: fewer than two segments, or its PCM is not one vocode "
                           "of its grid within the bound")
    if int(grid.min()) < 0 or int(grid.max()) > 1024:
        raise RuntimeError("stream_tts: grid codes outside [0, 1024]")
    return rec


def check_longform(tts, seed):
    """``synthesize_longform`` over a two-chunk text: finite audio whose
    length is the crossfade's (two trimmed segments, a 60 ms gap, a 20 ms
    overlap)."""
    import numpy as np
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.serving import chunk_text, synthesize_longform

    text = "The first sentence is read here. The second one follows it."
    transcript = "A reference voice."
    chunks = chunk_text(text, max_chars=40)
    n_text = max(len(tts.texttok.encode("<|startoftext|>" + transcript + " " + c
                                        + "<|endoftext|>", allowed_special="all"))
                 for c in chunks)
    cfg = InferenceConfig(generate_max_len_override=n_text + int(REF_SECONDS * 75) + GEN_FRAMES,
                          timesteps=STEPS)
    t0 = time.perf_counter()
    res = synthesize_longform(tts, text, reference_voice(tts, seed), ref_transcript=transcript,
                              cfg=cfg, max_chars=40, seed=seed)
    wall = time.perf_counter() - t0
    lens = [round(s * tts.sr) for s in res.chunk_audio_seconds]
    fade, gap = int(tts.sr * 0.020), int(tts.sr * 0.060)
    want = lens[0] + gap + lens[1] - min(fade, lens[0] + gap, lens[1])
    rec = {"chunks": res.chunks, "segment_samples": lens, "samples": len(res.audio),
           "wall_s": wall, "audio_s": len(res.audio) / tts.sr}
    print(f"synthesize_longform: chunks {res.chunks}, segments {lens} samples, stitched "
          f"{len(res.audio)} (crossfade length {want}), {wall:.3f} s for "
          f"{rec['audio_s']:.3f} s of audio", flush=True)
    if len(res.chunks) != 2 or len(res.audio) != want or not np.isfinite(res.audio).all():
        raise RuntimeError("synthesize_longform: not two chunks, or not the crossfade's "
                           "length, or non-finite audio")
    return rec


def check_pool(tts, seed):
    """``ContinuousBatcher`` on the fused4 engine (4 rows, chunks of 64 steps,
    prompt buckets 64 and 576) over six requests, three shallow and three
    deep (the 7 s reference), on injected streams: K2 launched once a pool
    step, every row's tokens equal to its solo ``ar_generate`` run on the
    pool's engine and stream, tokens a second of the pool and of the solo runs.
    The pool's ``max_len`` (one for all rows, as in the JAX pool) is the deep
    prompts' plus ``GEN_FRAMES``: a deep row generates at most
    ``GEN_FRAMES`` tokens, a shallow one up to ``max_len`` less its prompt.
    Returns (the record, the deep requests with their prompts' parts)."""
    import numpy as np
    import torch
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.models.ar_decode import ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    ref = reference_voice(tts, seed)
    codes = tts.encode_reference(ref).cpu().numpy()
    spk = codes[0].T
    texts = [("Shallow one, a short line.", False), ("Deep clone request one.", True),
             ("The shallow second line here.", False), ("Deep clone request two.", True),
             ("A third shallow line is read.", False), ("Deep clone request three.", True)]
    reqs = [request_prompt(tts, text, "A voice.", codes, deep) for text, deep in texts]
    deep_len = max(len(p) for (p, _, _), (_, deep) in zip(reqs, texts) if deep)
    sampling = tts._sampling(InferenceConfig(generate_max_len_override=deep_len + GEN_FRAMES),
                             30)
    rng = np.random.default_rng(seed)
    streams = [rng.random(sampling.max_len).astype(np.float32) for _ in reqs]
    t0 = time.perf_counter()
    engine = FusedEngine(*prepare_fused(tts.codeclm, sampling.max_len, 4, batch=POOL_ROWS))
    pool = ContinuousBatcher(tts.codeclm, sampling, engine=engine, batch_size=POOL_ROWS,
                             chunk_steps=POOL_CHUNK, prompt_buckets=POOL_BUCKETS,
                             spk_bucket=POOL_BUCKETS[-1])
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    submitted = [pool.submit(Request(prompt=p, spk_codes=spk, uniforms=u))
                 for (p, _, _), u in zip(reqs, streams)]
    reset_counts()
    t0 = time.perf_counter()
    pool.run()
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    launches = counts()
    t0 = time.perf_counter()
    solo = [ar_generate(tts.codeclm, p, spk, sampling=sampling, uniforms=u, engine=engine)
            for (p, _, _), u in zip(reqs, streams)]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    equal = [bool(np.array_equal(r.tokens, t)) and r.n_gen == n
             for r, (t, n) in zip(submitted, solo)]
    tokens = sum(r.n_gen for r in submitted)
    rec = {"rows": POOL_ROWS, "requests": len(reqs), "prompt_lens": [len(p) for p, _, _ in reqs],
           "n_gen": [r.n_gen for r in submitted], "steps": pool.steps_run,
           "chunks": pool.chunks_run, "prefills_by_bucket": pool.prefills_by_bucket,
           "k2_launches": launches["fused_decode_layers"], "rows_equal_solo": equal,
           "pool_s": pool_s, "solo_s": solo_s, "pack_s": pack_s,
           "pool_tokens_per_s": tokens / pool_s, "solo_tokens_per_s": tokens / solo_s}
    print(f"ContinuousBatcher (fused4, {POOL_ROWS} rows, chunks of {POOL_CHUNK}, buckets "
          f"{POOL_BUCKETS}): prompts {rec['prompt_lens']}, tokens {rec['n_gen']} in "
          f"{pool.steps_run} pool steps ({pool.chunks_run} quanta, prefills by bucket "
          f"{pool.prefills_by_bucket}), K2 launched {rec['k2_launches']} times; rows equal to "
          f"their solo runs: {equal}; pool {rec['pool_tokens_per_s']:.1f} tokens/s ({pool_s:.3f} "
          f"s) against {rec['solo_tokens_per_s']:.1f} for the six solo runs ({solo_s:.3f} s); "
          f"the pool's pack built in {pack_s:.2f} s", flush=True)
    if rec["k2_launches"] != pool.steps_run:
        raise RuntimeError("fused4 pool: K2 launches differ from the pool's steps")
    if not all(equal):
        raise RuntimeError("fused4 pool: a row's tokens differ from its solo run")
    if min(pool.prefills_by_bucket.values()) == 0:
        raise RuntimeError("fused4 pool: a prompt bucket took no prefill")
    deep = [(r, nar_text, fci) for r, (_, nar_text, fci), (_, d) in zip(submitted, reqs, texts)
            if d]

    def rerun():
        """A fresh pool with the same requests queued; returns its run."""
        again = ContinuousBatcher(tts.codeclm, sampling, engine=engine, batch_size=POOL_ROWS,
                                  chunk_steps=POOL_CHUNK, prompt_buckets=POOL_BUCKETS,
                                  spk_bucket=POOL_BUCKETS[-1])
        for (p, _, _), u in zip(reqs, streams):
            again.submit(Request(prompt=p, spk_codes=spk, uniforms=u))
        return again.run
    rec["_rerun"] = rerun
    return rec, deep, codes[0].T


def check_head_rows(fp, cfg, dev):
    """Why the quantized engine's int8 head runs at a fixed row count
    (``ar_decode_fused.final_logits``): row 0 of 2 to 8 rows through the
    final RMSNorm (bitwise the row alone's, so the norm runs at the real
    rows) and through the plain int8 head (``head_logits``, a cuBLAS f32
    GEMM at M = the rows) against the row alone, and through
    ``final_logits``, which must be bitwise the row alone's."""
    import torch
    from mars5_tts_torch.models.ar_decode_fused import final_logits, head_logits
    from mars5_tts_torch.ops.norms import rms_norm

    gen = own_generator(dev, 25)
    h = torch.randn((8, cfg.dim), generator=gen, device=dev) * 3
    hb = h.to(torch.bfloat16)
    sizes = range(2, 9)
    norm_one = rms_norm(hb[:1], fp["final_norm"], cfg.norm_eps)
    norm_equal = {b: bool(torch.equal(rms_norm(hb[:b], fp["final_norm"], cfg.norm_eps)[:1],
                                      norm_one)) for b in sizes}
    hn = rms_norm(hb, fp["final_norm"], cfg.norm_eps)
    one = head_logits(fp, hn[:1], cfg.n_vocab)
    plain = {b: (head_logits(fp, hn[:b], cfg.n_vocab)[:1] - one).abs().max().item()
             for b in sizes}
    fixed = final_logits(fp, h[:1], cfg)
    equal = {b: bool(torch.equal(final_logits(fp, h[:b], cfg)[:1], fixed)) for b in sizes}
    print(f"final RMSNorm, row 0 of 2..8 rows bitwise the row alone: {norm_equal}; int8 head, "
          f"row 0 of 2..8 rows against the row alone: plain max diff {plain}; final_logits "
          f"(the head at 8 rows always) bitwise equal {equal}", flush=True)
    if not all(equal.values()):
        raise RuntimeError("final_logits: a row's logits depend on the rows beside it")
    return {"norm_equal": norm_equal, "plain_max_diff": plain, "fixed_equal": equal}


def check_waves(tts, deep, c_codes):
    """``NarWaveScheduler`` (``wave_size=3``) on the int8 NAR over the pool's
    three deep rows (one reference, so one Lc): the generator path at
    T = 200 (finite grids, codes in [0, 1024], L0 the AR's), then at
    T = ``WAVE_T`` on injected streams, each wave row bit for bit the
    request's own one-row wave on its stream. The depth is the only cut: a
    T = 200 stream of the three rows (about 1,300 frames each, 8 lanes, 1,025
    classes, f32) would be about 60 GB, one of T = 8 about 2 GB."""
    import numpy as np
    import torch
    from mars5_tts_torch import DSH
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.serving import nar_waves
    from mars5_tts_torch.serving.nar_waves import NarRequest, NarWaveScheduler

    l0s = [parse_l0(tts, r.tokens, fci) for r, _, fci in deep]
    bucket = -(-max(len(x) for x in l0s) // 64) * 64
    text_bucket = -(-max(len(t) for _, t, _ in deep) // 32) * 32

    def scheduler(T):
        dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True, jump_len=1,
                  jump_n_sample=1, q0_override_steps=20, enable_kevin_scaled_inference=True,
                  guidance_interval=tts.guidance_interval)
        return NarWaveScheduler(tts.codecnar, MultinomialDiffusion(1025, T, device=tts.device),
                                T, dsh, wave_size=3, gen_buckets=(bucket,),
                                text_bucket=text_bucket, tail=tts.nar_tail, mega=tts._get_mega(),
                                options=tts.nar_options)

    def requests():
        return [NarRequest(c_text=t, c_codes=c_codes, l0_codes=x, seed=i)
                for i, ((_, t, _), x) in enumerate(zip(deep, l0s))]

    wave = scheduler(STEPS)
    reqs = [wave.submit(r) for r in requests()]
    reset_counts()
    t0 = time.perf_counter()
    wave.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    ok = wave.waves_run == 1 and all(
        r.grid.shape == (len(r.l0_codes), 8) and int(r.grid.min()) >= 0
        and int(r.grid.max()) <= 1024 and np.array_equal(r.grid[:, 0], r.l0_codes)
        for r in reqs)
    rec = {"rows": len(reqs), "frames": [len(x) for x in l0s], "gen_bucket": bucket,
           "lc": int(c_codes.shape[0]), "wall_s": wall, "nar_ms_per_step": 1e3 * wall / STEPS,
           "launches": launches}

    def rerun(T):
        """A fresh scheduler at depth T with the three rows queued; returns
        its flush."""
        again = scheduler(T)
        for r in requests():
            again.submit(r)
        return again.flush
    rec["_rerun"] = rerun
    print(f"NarWaveScheduler: one wave of {len(reqs)} deep rows (Lc {rec['lc']}, frames "
          f"{rec['frames']} in a bucket of {bucket}) at T = {STEPS} on the int8 NAR in "
          f"{wall:.3f} s ({rec['nar_ms_per_step']:.2f} ms a step); grids in range with L0 the "
          f"AR's: {ok}; launches {json.dumps(launches)}", flush=True)
    if not ok:
        raise RuntimeError("NarWaveScheduler: a wave grid out of range or L0 not the AR's")

    # T = WAVE_T on one injected stream a request (this check wraps the
    # scheduler's engine call to pass it)
    engine = nar_waves.perform_simple_inference
    lc = int(c_codes.shape[0])

    def stream(i, n_frames):
        g = torch.Generator(device=tts.device).manual_seed(100 + i)
        return (torch.rand((WAVE_T, 2, 1, lc + n_frames, 8, 1025), generator=g,
                           device=tts.device),
                torch.randint(0, 1025, (1, n_frames, 8), generator=g, device=tts.device))

    def injected(nar, batch, diff, T, dsh, **kw):
        kw.pop("generator")
        rows = [stream(int(s), batch[4].shape[1]) for s in injected.seeds]
        u = torch.cat([r[0] for r in rows], dim=2).cpu().numpy()
        x0 = torch.cat([r[1] for r in rows]).cpu().numpy()
        return engine(nar, batch, diff, T, dsh, uniforms=u, x_init=x0, **kw)

    nar_waves.perform_simple_inference = injected
    try:
        wave = scheduler(WAVE_T)
        reqs = [wave.submit(r) for r in requests()]
        injected.seeds = [r.seed for r in reqs]
        wave.flush()
        equal = []
        for r in requests():
            alone = scheduler(WAVE_T)
            a = alone.submit(r)
            injected.seeds = [r.seed]
            alone.flush()
            equal.append(bool(np.array_equal(a.grid, reqs[r.seed].grid)))
    finally:
        nar_waves.perform_simple_inference = engine
    rec["injected_rows_equal_solo"] = equal
    rec["injected_stream_gb"] = WAVE_T * 2 * 3 * (lc + bucket) * 8 * 1025 * 4 / 1e9
    print(f"NarWaveScheduler at T = {WAVE_T} on injected streams ({rec['injected_stream_gb']:.2f} "
          f"GB for the wave): each wave row equal to its one-row wave: {equal}", flush=True)
    if not all(equal):
        raise RuntimeError("NarWaveScheduler: a wave row differs from its solo run")
    return rec


def check_nocache(tts, req, seed):
    """``use_kv_cache=False`` on the bf16 AR (``ar_generate_nocache``: the
    full prefill a step) with a 60-token cap, beside the cached run on the
    same seed: ms a token of each and whether their tokens are equal. Not a
    gate: the full prefill and the one-token step round differently."""
    import numpy as np
    from mars5_tts_torch import InferenceConfig

    text, transcript, _ = req
    ref = reference_voice(tts, seed)
    prompt, _, _ = request_prompt(tts, text, transcript, tts.encode_reference(ref).cpu().numpy(),
                                  True)
    out = {}
    for cached in (False, True):
        cfg = InferenceConfig(generate_max_len_override=len(prompt) + 60, timesteps=WAVE_T,
                              use_kv_cache=cached)
        codes, audio = tts.tts(text, ref, ref_transcript=transcript, cfg=cfg, seed=seed)
        if not np.isfinite(audio).all():
            raise RuntimeError("use_kv_cache=False: non-finite audio")
        n_gen = AR_RUNS[-1][0][0][1]
        out[cached] = (codes, 1e3 * tts.last_timing["stages_s"]["ar_generate"] / max(n_gen, 1))
    rec = {"nocache_ms_per_token": out[False][1], "cached_ms_per_token": out[True][1],
           "tokens_equal": bool(np.array_equal(out[False][0], out[True][0]))}
    print(f"use_kv_cache=False (bf16 AR, prompt {len(prompt)} + 60 tokens): "
          f"{rec['nocache_ms_per_token']:.2f} ms a token against {rec['cached_ms_per_token']:.2f} "
          f"cached; tokens equal to the cached run's: {rec['tokens_equal']} (not a gate)",
          flush=True)
    return rec


def serve_serving(models, nar8, records, dev):
    """Phase 5: the serving requests at the released widths on the int8 NAR
    ``nar8``: the deploy configuration through ``tts()`` on the default route
    and with ``nar_mega=True`` (each beside phase 4's request on its route,
    from ``records``, for the NAR ms a step), ``stream_tts``,
    ``synthesize_longform``, the fused4 ``ContinuousBatcher``, ``NarWaveScheduler``
    and ``use_kv_cache=False``. Each part's launch counts are reset before
    it and read after it. Returns the records."""
    import torch

    import mars5_tts_torch.pipeline as pipeline
    from mars5_tts_torch import Mars5TTS

    ar = models["ar"]
    common = {k: models[k] for k in ("texttok", "speechtok", "encodec", "vocos")}
    layers = nar8.cfg.dec_layers
    no_modes = {"mha_int8": (0, 0), "fused_linear_grouped": (0, 0), "fused_ffn_grouped": (0, 0)}
    int8 = {"mha": (layers * STEPS, 10 ** 9),
            "fused_linear": (2 * layers * STEPS, 2 * layers * STEPS),
            "fused_ffn": (layers * STEPS, layers * STEPS),
            "heads_diffusion_tail": (STEPS, STEPS), "diffusion_tail": (0, 0),
            "mega_decoder_stack": (0, 0), **no_modes}
    mega = {**int8, "mha": (0, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
            "mega_decoder_stack": (STEPS, STEPS)}
    fused_ar = {"fused_decode_layers": lambda n: (n, n), "head4_logits": (0, 0),
                "decode_attention": (0, 0)}
    first = ("The quick brown fox jumps over the lazy dog.", "A reference voice.", 11)
    recs = {}
    torch.cuda.reset_peak_memory_stats(dev)
    tts = Mars5TTS.from_params(ar, nar8, **DEPLOY, **common)
    phase4 = {r["path"]: r for r in records}
    recs["deploy"] = serve_deploy(tts, "deploy: fused4 + int8, guidance_interval (0, 0.5), "
                                  "buckets 64 / 32", first, {**int8, **fused_ar},
                                  phase4["fused4 AR + int8 NAR"])
    tts_mega = Mars5TTS.from_params(ar, nar8, nar_mega=True, **DEPLOY, **common)
    recs["deploy_mega"] = serve_deploy(tts_mega, "deploy with nar_mega=True", first,
                                       {**mega, **fused_ar},
                                       phase4["fused4 AR + int8 NAR, nar_mega=True"])
    del tts_mega
    recs["stream"] = check_stream(tts, first, 15)
    recs["longform"] = check_longform(tts, 16)
    recs["pool"], deep, c_codes = check_pool(tts, 17)
    recs["head_rows"] = check_head_rows(tts._ar_engine(AR_MAX_LEN).fp, ar.cfg, dev)
    recs["waves"] = check_waves(tts, deep, c_codes)
    del tts
    pipeline.ar_generate_nocache = record_ar(pipeline.ar_generate_nocache)
    recs["nocache"] = check_nocache(Mars5TTS.from_params(ar, nar8, nar_backend="int8", **common),
                                    first, 18)
    print(json.dumps({"serving": {k: {kk: vv for kk, vv in v.items()
                                      if kk != "launches" and not kk.startswith("_")}
                                  for k, v in recs.items()}}, default=str), flush=True)
    return recs


SERVING_K6 = (  # (bs, rows, t, greedy): the serving path's K6 / K5 calls at 750 frames
    (1, 1, 150, False), (1, 1, 199, False),    # cond-only steps of the guidance interval
    (1, 2, 0, True),                           # CFG, the greedy last step: scalars[5] = 0
    (3, 6, 50, False), (3, 3, 150, False))     # a NAR wave of three rows, CFG and cond-only


def check_heads_tail_serving(dev):
    """K6 at the serving path's new shapes (``SERVING_K6``): indices equal
    to the twin's except within its 1e-5 near-ties, K5 on the folded heads'
    bf16 logits equal to K6 and to its twin, with each call's times."""
    import torch
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    gen = own_generator(dev, 23)
    wf = torch.randn((LANES, CLASSES, DIM), generator=gen, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((LANES, CLASSES), generator=gen, device=dev)}
    diff = MultinomialDiffusion(CLASSES, timesteps=STEPS, device=dev)
    res = {}
    for bs, rows, t, greedy in SERVING_K6:
        out = torch.randn((rows, GEN_LEN, DIM), generator=gen, device=dev).to(torch.bfloat16)
        x8, xs = nar_heads_prequant(out)
        u0 = torch.rand((bs, GEN_LEN, LANES, CLASSES), generator=gen, device=dev)
        x_t = torch.randint(0, CLASSES, (bs, GEN_LEN, LANES), generator=gen, device=dev)
        args = (x8, xs, folded, u0, x_t, D.tail_scalars(diff, t, use_gumbel=not greedy))
        got = D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
        want = D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)
        scores = D.tail_scores(*args, w=3.0, temp=0.7)
        top2 = torch.topk(scores, 2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) <= 1e-5
        logits = nar_heads_folded(folded, out)
        tail_args = (logits, *args[3:])
        got5 = D.diffusion_tail(*tail_args, w=3.0, temp=0.7)
        want5 = D.diffusion_tail_ref(*tail_args, w=3.0, temp=0.7)
        torch.cuda.synchronize()
        bad = int(((got != want) & ~near_tie).sum())
        run6 = lambda: D.heads_diffusion_tail(*args, w=3.0, temp=0.7)   # noqa: E731
        st = {"bs": bs, "rows": rows, "t": t, "use_gumbel": not greedy,
              "mismatches": int((got != want).sum()), "near_ties": int(near_tie.sum()),
              "max_abs_err": (top2[..., 0] - scores.gather(-1, got[..., None])[..., 0])
              .max().item(), "k5_vs_k6": int((got5 != got).sum()),
              "k5_vs_twin": int((got5 != want5).sum()), "ms": cuda_ms(run6),
              "plain_ms": cuda_ms(lambda: D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7),
                                  n=5, warmup=1),
              "device_ms": device_ms(run6),
              "k5_device_ms": device_ms(lambda: D.diffusion_tail(*tail_args, w=3.0, temp=0.7))}
        st["bound_ms"], st["bound_by"] = bound(
            nbytes(x8, xs, *folded.values(), *args[3:], got),
            int8=2 * rows * GEN_LEN * LANES * CLASSES * DIM)
        name = f"({bs}, {GEN_LEN}) rows {rows} t={t}" + (" greedy" if greedy else "")
        res[name] = st
        print(f"K6 heads+tail {name}: index mismatches {st['mismatches']} of {got.numel()} "
              f"(twin near-ties {st['near_ties']}, outside them {bad}); K5 against K6 "
              f"{st['k5_vs_k6']}, against its twin {st['k5_vs_twin']} (bound: 0) | K6 "
              f"{st['ms'] * 1e3:.1f} us (device {fmt_us(st['device_ms'])}), K5 device "
              f"{fmt_us(st['k5_device_ms'])}, plain {st['plain_ms'] * 1e3:.1f} us, roofline "
              f"{st['bound_ms'] * 1e3:.1f} us ({st['bound_by']})", flush=True)
        if bad or st["k5_vs_k6"] or st["k5_vs_twin"]:
            raise RuntimeError(f"K6/K5 {name}: indices differ from the twin")
    return res


def check_mega_one_row(dec, dev, length):
    """K9 at one batch row (a cond-only step: ``mega_plan`` at M = L) over the
    smoke's 66-token memory, masks on: each of the 16 layers alone,
    teacher-forced, within the fused bound, and the 16 in one call within
    the stack's mean gate, as ``check_mega`` holds two rows."""
    import dataclasses

    import torch
    from mars5_tts_torch.ops.kernels import nar_mega as M

    gen = own_generator(dev, 30 + length)
    mp = M.build_mega_pack(dec)
    d = mp.dims
    x = torch.randn((1, length, DIM), generator=gen, device=dev).to(torch.bfloat16)
    mem = torch.randn((1, MEGA_LK, DIM), generator=gen, device=dev).to(torch.bfloat16)
    tm = torch.zeros((1, length), dtype=torch.bool, device=dev)
    tm[0, length - length // 6:] = True
    mm = torch.zeros((1, MEGA_LK), dtype=torch.bool, device=dev)
    mm[0, MEGA_LK - 5:] = True
    per_layer, ok_layers, h = [], True, x
    for i in range(d.n_layers):
        li = M.MegaPack(dataclasses.replace(d, n_layers=1), mp.pack[i:i + 1], mp.svec[i:i + 1],
                        mp.bvec[i:i + 1], mp.lnvec[i:i + 1])
        got_i = M.mega_decoder_stack(li, h, mem, tm, mm)
        ok_i, st_i = fused_bound(got_i, M.mega_decoder_stack_ref(li, h, mem, tm, mm))
        ok_layers &= ok_i
        per_layer.append(st_i)
        h = got_i
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    want = M.mega_decoder_stack_ref(mp, x, mem, tm, mm)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    peak = want.float().abs().max().item()
    ok = ok_layers and bool(torch.isfinite(got).all()) and diff.mean().item() <= 8e-3 * peak
    st = {"max_abs_err": max(p["max_abs_err"] for p in per_layer),
          "exact_min": min(p["exact_frac"] for p in per_layer),
          "stack_mean_abs_err": diff.mean().item(), "stack_peak": peak,
          "plan": dict(zip(M.SITES, M.mega_plan(d, length, MEGA_LK, sm_count(dev)))),
          **mega_times(M, lambda: M.mega_decoder_stack(mp, x, mem, tm, mm),
                       lambda: M.mega_decoder_stack_ref(mp, x, mem, tm, mm))}
    st["bound_ms"], st["bound_by"] = mega_bound(mp, x, mem, tm, mm, got)
    print(f"K9 mega_decoder_stack (1, {length}, {DIM}) over memory (1, {MEGA_LK}, {DIM}), "
          f"masks on: each layer alone bound=fused_eq within={ok_layers} (max_abs_err "
          f"{st['max_abs_err']:.3e}, exactly equal >= {st['exact_min']:.5f}); {d.n_layers} "
          f"layers mean_abs_err={st['stack_mean_abs_err']:.3e} (peak {peak:.3f}) bound=mean "
          f"<= 8e-3 x peak within={ok} | " + mega_times_txt(st)
          + f"; site plan (tile_b, grid) {st['plan']}", flush=True)
    if not ok:
        raise RuntimeError(f"K9 (1, {length}): error above its bound")
    return st


def check_nar_fused_one_row(dev, length=MEGA_BENCH_L):
    """K3 (qkv with LN + bias; bitwise) and K4 (at least 99.9% equal) at one
    batch row's M = ``length``, a cond-only step's."""
    import torch
    from mars5_tts_torch.ops.kernels import nar_fused as F

    gen = own_generator(dev, 24)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
    x = torch.randn((1, length, DIM), generator=gen, device=dev).to(torch.bfloat16)
    ln = (vec(DIM, 1.0), vec(DIM))
    qkv_w, qkv_b = rand_qweight(3 * DIM, DIM, gen, dev), vec(3 * DIM)
    w, v, l2 = (rand_qweight(FFN, DIM, gen, dev), rand_qweight(FFN, DIM, gen, dev),
                rand_qweight(DIM, FFN, gen, dev))
    l2_b = vec(DIM)
    return {
        "qkv": check_w8a8(f"K3 qkv (1, {length}, 1024) -> 3072, LN + bias",
                          lambda: F.fused_linear(x, qkv_w, ln=ln, bias=qkv_b),
                          lambda: F.fused_linear_ref(x, qkv_w, ln=ln, bias=qkv_b),
                          nbytes(x, *qkv_w, qkv_b, *ln), 2 * length * 3 * DIM * DIM, 1.0),
        "ffn": check_w8a8(f"K4 ffn (1, {length}, 1024), F 3072",
                          lambda: F.fused_ffn(x, ln, w, v, l2, l2_b),
                          lambda: F.fused_ffn_ref(x, ln, w, v, l2, l2_b),
                          nbytes(x, *ln, *w, *v, *l2, l2_b), 2 * length * 3 * DIM * FFN, 0.999)}



IDLE_WAVE_T = 20    # the wave's depth for its idle share (a trace of 200 steps is too long)


def check_dp_decoder(models, dev):
    """Phase 6 (d): ``ShardedARDecoder`` in a one-process NCCL group (dp = 1)
    on the served bf16 AR, three requests on injected streams: tokens
    bitwise those of ``ar_generate_batched``; K7's launches counted around
    the sharded run alone."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate_batched
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder

    ar = models["ar"]
    rng = np.random.default_rng(61)
    s = ArSampling(temperature=0.7, top_k=200, top_p=0.9, n_phones_gen=40, eos_idx=258 + 1024,
                   valid_start=258, valid_end=258 + 1025, max_len=200)
    prompts = [rng.integers(0, 258 + 1025, n) for n in (120, 90, 150)]
    spks = [rng.integers(0, 1024, (n, 8)) for n in (150, 100, 200)]
    uniforms = [rng.random(s.max_len).astype(np.float32) for _ in prompts]
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=dev if dev.type == "cuda" else None)
    try:
        dec = ShardedARDecoder(ar, s, mesh=make_mesh(tp=1))
        dec.generate(prompts[:1], spks[:1], uniforms=uniforms[:1])      # warm
        reset_counts()
        t0 = time.perf_counter()
        got = dec.generate(prompts, spks, uniforms=uniforms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k7 = counts()["decode_attention"]
    finally:
        dist.destroy_process_group()
    want = ar_generate_batched(ar, prompts, spks, sampling=s, uniforms=np.stack(uniforms, 1))
    same = all(n == wn and t.tolist() == wt.tolist() for (t, n), (wt, wn) in zip(got, want))
    rec = {"rows": len(prompts), "tokens": [n for _, n in got], "bitwise": same,
           "wall_s": wall, "decode_attention_launches": k7}
    print("phase 6 (d) ShardedARDecoder, one-process NCCL (dp=1), bf16 AR: "
          + json.dumps(rec), flush=True)
    if not same:
        raise RuntimeError("ShardedARDecoder(dp=1) parted from ar_generate_batched")
    if k7 <= 0:
        raise RuntimeError("ShardedARDecoder did not launch K7 on the card")
    return rec


def check_tp_decoders(smi):
    """Phase 6 (e): ``ShardedARDecoder`` and ``ShardedNARDiffusion`` at dp 1 x
    tp ``TP``, the ranks two processes of one gloo group on the card, each
    holding its half of the released-width bf16 AR and NAR (drawn from
    phase 4's seed): ``tools/tp_card.run`` and its gates (``check``): the
    ranks' tokens, grid and teacher-forced logits equal, the logits and
    the grid's differing cells within their budgets of one process's, each
    rank's K7 and K1 calls within their twins' bounds on the same inputs,
    K7 26 a decode step and K1 16 a reverse step plus the speaker
    encoder's 3, on each rank. Reported: the tokens agreeing with the
    one-process run before the first difference (and one process's bf16
    against f32) and each rank's ms a token and a step (two ranks sharing
    one card over gloo: not tensor-parallel speed)."""
    from mars5_tts_torch.tools import tp_card

    t0 = time.perf_counter()
    spec, outs = tp_card.run(TP, timeout=400)
    rep = tp_card.check(spec, outs, n_layers=26, dec_layers=16, spk_layers=3)
    rep["wall_s"] = time.perf_counter() - t0
    print(f"phase 6 (e) tensor-parallel decoders, dp=1 x tp={TP} over gloo on one card "
          f"({smi}): " + json.dumps(rep), flush=True)
    return rep


TRAIN_STEPS = 5


GRAD_NAMES = {"ar": ("embed.weight", "ar.layers.0.attention.wq.weight",
                     "ar.layers.1.feed_forward.w2.weight", "ar.output.weight"),
              "nar": ("text_embed.weight", "tfm.encoder.layers.0.self_attn.in_proj_weight",
                      "tfm.decoder.layers.1.activation.W.weight", "residual_decoder.3.1.weight")}


def card_vs_cpu(dev):
    """Phase 6 (b): one step's losses and gradient norms, the card against
    the CPU, at full width and two layers each on the same weights, batch
    and draws."""
    import torch

    from mars5_tts_torch import train as T
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.tools.profile_train import train_batches, train_models

    ab, nb = train_batches()
    cpu = torch.device("cpu")
    ar, nar = train_models(cpu, n_layers=2)
    draws = T.nar_draws(MultinomialDiffusion(1025, timesteps=200), nb[4].shape,
                        torch.Generator().manual_seed(13))
    out = {}
    for where in (cpu, dev):
        a, n = (m.to(where) for m in (ar, nar))
        diff = MultinomialDiffusion(1025, timesteps=200, device=where)
        d = T.NarDraws(*(x.to(where) for x in (draws.t, draws.u, draws.drop)))
        rec = {}
        for kind, model, loss_fn in (
                ("ar", a, lambda: T.ar_loss_fn(a, *T.to_batch(ab, T.AR_DTYPES, where))),
                ("nar", n, lambda: T.nar_loss_fn(n, diff, T.to_batch(nb, T.NAR_DTYPES, where),
                                                 d))):
            params = dict(model.named_parameters())
            loss = loss_fn()
            grads = torch.autograd.grad(loss, [params[k] for k in GRAD_NAMES[kind]])
            rec[f"{kind}_loss"] = float(loss)
            rec.update({f"{kind}:{k}": float(g.double().norm())
                        for k, g in zip(GRAD_NAMES[kind], grads)})
        out[where.type] = rec
    worst = {k: abs(out["cuda"][k] - v) / abs(v) for k, v in out["cpu"].items()}
    loss_worst = max(worst[k] for k in ("ar_loss", "nar_loss"))
    grad_worst = max(v for k, v in worst.items() if ":" in k)
    print(f"phase 6 (b) card against CPU, full width x 2 layers: losses {out['cuda']['ar_loss']:.6f} "
          f"/ {out['cuda']['nar_loss']:.6f} (CPU {out['cpu']['ar_loss']:.6f} / "
          f"{out['cpu']['nar_loss']:.6f}); worst relative: losses {loss_worst:.3e} (gate 1e-5), "
          f"gradient norms {grad_worst:.3e} (gate 1e-4) over {sorted(GRAD_NAMES['ar'])} + "
          f"{sorted(GRAD_NAMES['nar'])}", flush=True)
    if loss_worst > 1e-5 or grad_worst > 1e-4:
        raise RuntimeError(f"training on the card parted from the CPU: {json.dumps(worst)}")
    return {"loss_rel": loss_worst, "grad_norm_rel": grad_worst, "cpu": out["cpu"],
            "cuda": out["cuda"]}


def k1_refuses_training(dev):
    """Phase 6 (c): a NAR forward at 600 frames (self-attention past K1's
    512-query threshold) with autograd recording must raise."""
    import torch

    from mars5_tts_torch.tools.profile_train import train_models

    _, nar = train_models(dev, n_layers=1)
    bs, lx = 1, 600
    args = (torch.zeros((bs, 8), dtype=torch.long, device=dev),
            torch.zeros((bs, 10, 8), dtype=torch.long, device=dev),
            torch.full((bs,), 8, device=dev), torch.full((bs,), 10, device=dev),
            torch.zeros((bs, lx, 8), dtype=torch.long, device=dev),
            torch.zeros((bs, lx), dtype=torch.bool, device=dev),
            torch.zeros((bs,), dtype=torch.long, device=dev))
    try:
        nar(*args)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"phase 6 (c) K1 refused a training forward at {lx} frames: {e}", flush=True)
        return str(e)
    raise RuntimeError("a NAR forward at 600 frames with grad enabled ran through K1")


def train_phase(models, dev):
    """Phase 6 (a)-(c) (see the module docstring)."""
    import torch

    from mars5_tts_torch.tools.profile_train import train_run

    del models
    gc.collect()
    torch.cuda.empty_cache()
    runs = [train_run(dev, False, TRAIN_STEPS), train_run(dev, True, 2)]
    for r in runs:
        print(f"phase 6 (a) training, released widths f32, {r['params_m']:.0f}M params, "
              f"remat={r['remat']}: AR {r['ar_ms_median']:.1f} ms a step "
              f"({r['ar_tokens_per_s']:.0f} tokens a second), NAR {r['nar_ms_median']:.1f} ms "
              f"a step, peak {r['peak_gb']:.2f} GB above the {r['base_gb']:.2f} GB the "
              "process held before; " + json.dumps(r), flush=True)
    return {"runs": runs, "card_vs_cpu": card_vs_cpu(dev), "k1": k1_refuses_training(dev)}


def serving_idle_shares(serving):
    """The device's idle share of the pool's run and of a wave, after every
    other measurement (``torch.profiler`` slows a process's later launches):
    the wall of an unprofiled run, the device's busy time (its own events,
    ``tools/profile_ar.device_us``) of the same work under the profiler,
    idle = 1 - busy / wall. The pool reruns phase 5's six requests; the wave
    its three deep rows at T = ``IDLE_WAVE_T``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.tools.profile_ar import device_us

    out = {}
    for name, make in (("pool", serving["pool"]["_rerun"]),
                       ("wave", lambda: serving["waves"]["_rerun"](IDLE_WAVE_T))):
        make()()                            # warm
        run = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        run = make()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = device_us(prof.key_averages())
        out[name] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                     "idle_share": 1.0 - busy / wall_us}
    print("serving idle shares (device busy under the profiler against an unprofiled wall): "
          + json.dumps(out), flush=True)
    return out


# ------------------------------------------- 7. entry points from files on disk

ENTRY_REQUEST = ("The quick brown fox jumps over the lazy dog.", "A reference voice.", 11)


def snapshot_weights(models):
    """Host copies of the AR's and NAR's weights and configs, taken before
    phase 4 quantizes the NAR and lets the bf16 one go: phase 7 writes its
    checkpoints from them."""
    return {name: ({k: v.detach().to("cpu", copy=True)
                    for k, v in models[name].state_dict().items()}, models[name].cfg)
            for name in ("ar", "nar")}


def encodec_official(enc):
    """Phase 4's Encodec as an official ``encodec_24khz`` state dict (the
    inverse of ``convert_encodec``), every conv in the weight-norm form
    ``weight_g`` / ``weight_v`` that ``_fold_weight_norm`` folds back."""
    sd = {}

    def conv(prefix, m):
        w = m.weight.detach().float().cpu()
        sd[f"{prefix}.weight_g"] = w.square().sum(dim=(1, 2), keepdim=True).sqrt()
        sd[f"{prefix}.weight_v"] = w.clone()
        sd[f"{prefix}.bias"] = m.bias.detach().float().cpu()

    conv("encoder.model.0.conv.conv", enc.init)
    idx = 1
    for st in enc.stages:
        conv(f"encoder.model.{idx}.block.1.conv.conv", st.res.conv1)
        conv(f"encoder.model.{idx}.block.3.conv.conv", st.res.conv2)
        conv(f"encoder.model.{idx}.shortcut.conv.conv", st.res.shortcut)
        conv(f"encoder.model.{idx + 2}.conv.conv", st.down)
        idx += 3
    for name, p in enc.lstm.named_parameters():
        sd[f"encoder.model.{idx}.lstm.{name}"] = p.detach().float().cpu()
    conv(f"encoder.model.{idx + 2}.conv.conv", enc.final)
    for q, e in enumerate(enc.codebooks):
        sd[f"quantizer.vq.layers.{q}._codebook.embed"] = e.detach().float().cpu()
    return sd


def vocos_official(voc):
    """Phase 4's Vocos as an official ``vocos-encodec-24khz`` state dict (the
    inverse of ``convert_vocos``)."""
    t = lambda p: p.detach().float().cpu()            # noqa: E731
    sd = {"backbone.embed.weight": t(voc.embed.weight), "backbone.embed.bias": t(voc.embed.bias),
          "backbone.norm.scale.weight": t(voc.norm.scale),
          "backbone.norm.shift.weight": t(voc.norm.shift),
          "backbone.final_layer_norm.weight": t(voc.final_layer_norm.weight),
          "backbone.final_layer_norm.bias": t(voc.final_layer_norm.bias),
          "head.out.weight": t(voc.out.weight), "head.out.bias": t(voc.out.bias)}
    for i, blk in enumerate(voc.convnext):
        pre = f"backbone.convnext.{i}"
        sd.update({f"{pre}.dwconv.weight": t(blk.dwconv.weight),
                   f"{pre}.dwconv.bias": t(blk.dwconv.bias),
                   f"{pre}.norm.scale.weight": t(blk.norm.scale),
                   f"{pre}.norm.shift.weight": t(blk.norm.shift),
                   f"{pre}.pwconv1.weight": t(blk.pwconv1.weight),
                   f"{pre}.pwconv1.bias": t(blk.pwconv1.bias),
                   f"{pre}.pwconv2.weight": t(blk.pwconv2.weight),
                   f"{pre}.pwconv2.bias": t(blk.pwconv2.bias), f"{pre}.gamma": t(blk.gamma)})
    cb = t(voc.codebook_weights).reshape(voc.cfg.n_codebooks, voc.cfg.codebook_size, -1)
    for k in range(voc.cfg.n_codebooks):
        sd[f"feature_extractor.encodec.quantizer.vq.layers.{k}._codebook.embed"] = cb[k]
    return sd


def tokenizer_vocab(models):
    """The checkpoints' vocab entry: both tokenizers' model files as text."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out = {}
        for key, tok in (("texttok.model", models["texttok"]),
                         ("speechtok.model", models["speechtok"])):
            tok.save(str(Path(d) / key[:-6]))
            out[key] = (Path(d) / key).read_text()
    return out


def write_entry_files(d, snap, models):
    """Phase 7 (a): the AR and NAR through the port's ``save_checkpoint`` (f32
    leaves, the tokenizers in the vocab, the config beside them: safetensors
    where the package imports, else the reference's .pt layout), Encodec
    and Vocos as official-key state dicts through ``torch.save``, and the
    request's 7 s reference as a PCM16 WAV. Returns the paths."""
    import dataclasses
    import importlib.util

    import numpy as np
    import torch
    from mars5_tts_torch.audio.io import write_wav
    from mars5_tts_torch.hub import save_checkpoint
    from mars5_tts_torch.models.convert import unpermute_rope_rows

    fmt = "safetensors" if importlib.util.find_spec("safetensors") else "pt"
    vocab = tokenizer_vocab(models)
    paths = {"ar": d / f"mars5_ar.{fmt}", "nar": d / f"mars5_nar.{fmt}",
             "encodec": d / "encodec_24khz.pt", "vocos": d / "vocos_encodec_24khz.pt",
             "ref": d / "reference.wav", "format": fmt}
    t0 = time.perf_counter()
    for name in ("ar", "nar"):
        sd, cfg = snap[name]
        tensors = {k: v.float().numpy() for k, v in sd.items()}
        if name == "ar":
            for k in [k for k in tensors if k.endswith(("attention.wq.weight",
                                                        "attention.wk.weight"))]:
                tensors[k] = unpermute_rope_rows(tensors[k], cfg.head_dim)
        save_checkpoint(paths[name], tensors, vocab, config=dataclasses.asdict(cfg))
    torch.save(encodec_official(models["encodec"]), paths["encodec"])
    torch.save(vocos_official(models["vocos"]), paths["vocos"])
    rng = np.random.default_rng(ENTRY_REQUEST[2])
    write_wav(paths["ref"], (rng.standard_normal(int(REF_SECONDS * 24000)) * 0.1).astype(
        np.float32))
    write_s = time.perf_counter() - t0
    sizes = {k: paths[k].stat().st_size for k in ("ar", "nar", "encodec", "vocos")}
    print(f"phase 7 (a): wrote the checkpoints as {fmt} ("
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in sizes.items())
          + f") and the reference WAV in {write_s:.1f} s", flush=True)
    return paths, {"format": fmt, "write_s": write_s, "bytes": sizes}


def wav_pcm(path):
    import wave

    import numpy as np
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def entry_cli(paths, models, steps_want):
    """Phase 7 (b): one deep-clone request through ``cli.main`` (the card by
    default) and the same request through ``Mars5TTS.from_local(...).tts`` on
    the same files and seed: the WAV's PCM equal sample for sample; K7 26
    launches a decode step and K1 at least one a decoder layer a reverse
    step; no quantized kernel. The load seconds (the codecs' conversion and
    ``from_local``) are the in-process load's, the same work as the CLI's."""
    import contextlib
    import io

    import numpy as np
    import torch
    from mars5_tts_torch import InferenceConfig, Mars5TTS, cli
    from mars5_tts_torch.audio.io import float_to_pcm16, read_wav
    from mars5_tts_torch.hub import load_codec_params

    text, transcript, seed = ENTRY_REQUEST
    n_text = len(models["texttok"].encode("<|startoftext|>" + transcript + " " + text
                                          + "<|endoftext|>", allowed_special="all"))
    max_len = n_text + int(REF_SECONDS * 75) + GEN_FRAMES
    out = paths["ref"].parent / "cli.wav"
    argv = ["--text", text, "--ref", str(paths["ref"]), "--transcript", transcript,
            "--ar", str(paths["ar"]), "--nar", str(paths["nar"]), "--encodec",
            str(paths["encodec"]), "--vocos", str(paths["vocos"]), "--out", str(out),
            "--max-len", str(max_len), "--timesteps", str(STEPS), "--seed", str(seed),
            "--timings"]
    reset_counts()
    AR_RUNS.clear()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(f"phase 7 (b) cli: {ln}", flush=True)
    if rc != 0:
        raise RuntimeError(f"phase 7 (b): cli.main returned {rc}")
    timing = json.loads(lines[-1])
    (rows, run_max_len), = AR_RUNS
    steps = decode_steps(rows, run_max_len)
    check_launches("phase 7 (b) CLI", launches, steps_want, steps)
    t0 = time.perf_counter()
    codecs = {"encodec_params": load_codec_params(paths["encodec"], "encodec"),
              "vocos_params": load_codec_params(paths["vocos"], "vocos")}
    codecs_s = time.perf_counter() - t0
    tts = Mars5TTS.from_local(paths["ar"], paths["nar"], **codecs)
    load_s = time.perf_counter() - t0
    _, audio = tts.tts(text, read_wav(paths["ref"], 24000)[0], ref_transcript=transcript,
                       cfg=InferenceConfig(generate_max_len_override=max_len, timesteps=STEPS),
                       seed=seed)
    del tts
    want, got = float_to_pcm16(audio), wav_pcm(out)
    if got.shape != want.shape or not np.array_equal(got, want):
        n = min(len(got), len(want))
        diff = int((got[:n] != want[:n]).sum()) + abs(len(got) - len(want))
        raise RuntimeError(f"phase 7 (b): the CLI's WAV differs from the in-process tts in "
                           f"{diff} of {max(len(got), len(want))} samples")
    (_, n_gen), = rows
    rec = {"path": "CLI: bf16 AR + bf16 NAR from files (f32 weights)", "wall_s": wall,
           "load_s": load_s, "codecs_s": codecs_s,
           "ar_tokens": n_gen, "ar_steps": steps, "samples": int(len(got)),
           "pcm_equal_in_process": True, "launches": launches,
           "ar_ms_per_token": 1e3 * timing["stages_s"]["ar_generate"] / max(n_gen, 1),
           "nar_ms_per_step": 1e3 * timing["stages_s"]["nar_diffusion"] / STEPS,
           "stages_s": {k: round(v, 4) for k, v in timing["stages_s"].items()}}
    print(f"phase 7 (b) CLI: {n_gen} AR tokens ({steps} decode steps), {len(got)} samples equal "
          f"to the in-process tts; the in-process load from the files {load_s:.2f} s (the codec "
          f"conversion {codecs_s:.2f} s of it); AR {rec['ar_ms_per_token']:.2f} ms a token, NAR "
          f"{rec['nar_ms_per_step']:.2f} ms a step; wall {wall:.2f} s; K7 "
          f"{launches['decode_attention']}, K1 {launches['mha']}; stages "
          + json.dumps(rec["stages_s"]), flush=True)
    return rec


def entry_predictor(paths, want, want_mega, serving):
    """Phase 7 (c): ``Predictor().setup()`` from the environment (the
    checkpoints in ``MARS5_*_CKPT``, every route switch at its default) and
    ``predict``: phase 5's deploy checks (K2 once a decode step, K6 100 CFG
    + 100 cond-only calls, K3 and K4 once a decoder layer a reverse step),
    its NAR ms a step beside phase 5's; then ``setup()`` again with
    ``MARS5_NAR_MEGA=1``: K9 once a reverse step."""
    import os

    import numpy as np
    import torch
    from mars5_tts_torch.audio.io import read_wav
    from mars5_tts_torch.deploy.predict import Predictor
    from mars5_tts_torch.diffusion import engine

    text, transcript, _ = ENTRY_REQUEST
    saved = {k: os.environ.pop(k) for k in [k for k in os.environ if k.startswith("MARS5_")]}
    os.environ.update({f"MARS5_{k.upper()}_CKPT": str(paths[k])
                       for k in ("ar", "nar", "encodec", "vocos")})
    recs = {}
    try:
        for label, extra, want_k in (("Predictor (deploy)", {}, want),
                                     ("Predictor, MARS5_NAR_MEGA=1", {"MARS5_NAR_MEGA": "1"},
                                      want_mega)):
            os.environ.update(extra)
            t0 = time.perf_counter()
            pred = Predictor()
            pred.setup()
            setup_s = time.perf_counter() - t0
            if pred.model.nar_mega != bool(extra):
                raise RuntimeError(f"phase 7 (c) {label}: nar_mega is {pred.model.nar_mega}")
            rows_cfg, undo = count_tail_rows(engine)
            reset_counts()
            AR_RUNS.clear()
            t0 = time.perf_counter()
            try:
                out = pred.predict(text, str(paths["ref"]), transcript,
                                   out_path=str(paths["ref"].parent / "predict.wav"))
            finally:
                undo()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
            (rows, run_max_len), = AR_RUNS
            steps = decode_steps(rows, run_max_len)
            check_launches(f"phase 7 (c) {label}", launches, want_k, steps)
            n_cfg = sum(rows_cfg)
            if (n_cfg, len(rows_cfg) - n_cfg) != (STEPS // 2, STEPS // 2):
                raise RuntimeError(f"phase 7 (c) {label}: K6 ran {n_cfg} CFG and "
                                   f"{len(rows_cfg) - n_cfg} cond-only calls, expected "
                                   f"{STEPS // 2} each")
            audio, _ = read_wav(out)
            if not (len(audio) > 0 and np.isfinite(audio).all()):
                raise RuntimeError(f"phase 7 (c) {label}: empty or non-finite WAV")
            timing = pred.model.last_timing
            grid = tuple(pred.model.last_grid.shape)
            del pred
            (_, n_gen), = rows
            phase5 = serving["deploy_mega" if extra else "deploy"]
            rec = {"path": label, "setup_s": setup_s, "wall_s": wall, "ar_tokens": n_gen,
                   "ar_steps": steps, "grid": list(grid), "launches": launches,
                   "ar_ms_per_token": 1e3 * timing["stages_s"]["ar_generate"] / max(n_gen, 1),
                   "nar_ms_per_step": 1e3 * timing["stages_s"]["nar_diffusion"] / STEPS,
                   "phase5_nar_ms_per_step": phase5["nar_ms_per_step"],
                   "phase5_grid": phase5["grid"],
                   "stages_s": {k: round(v, 4) for k, v in timing["stages_s"].items()}}
            print(f"phase 7 (c) {label}: setup {setup_s:.2f} s; {n_gen} AR tokens, grid {grid}, "
                  f"AR {rec['ar_ms_per_token']:.2f} ms a token, NAR {rec['nar_ms_per_step']:.2f} "
                  f"ms a step against phase 5's {phase5['nar_ms_per_step']:.2f} (grid "
                  f"{tuple(phase5['grid'])}); launches {json.dumps(launches)}", flush=True)
            recs[label] = rec
    finally:
        for k in [k for k in os.environ if k.startswith("MARS5_")]:
            del os.environ[k]
        os.environ.update(saved)
    return recs


def entry_int8_ar(models, nar8, records, want):
    """Phase 7 (d): ``quantize_codeclm`` (weight-only int8) of the served AR
    on the bf16 engine with the int8 NAR, one request: finite audio, every
    generated token inside the vocabulary window, K7 26 launches a decode
    step; its AR ms a token beside phase 4's bf16 AR on the same request."""
    import mars5_tts_torch.pipeline as pipeline
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.ops.quant import quantize_codeclm

    t0 = time.perf_counter()
    q_ar = quantize_codeclm(models["ar"])
    quant_s = time.perf_counter() - t0
    common = {k: models[k] for k in ("texttok", "speechtok", "encodec", "vocos")}
    tts = Mars5TTS.from_params(q_ar, nar8, nar_backend="int8", **common)
    seqs = []
    engine = pipeline.ar_generate

    def capture(*a, **k):
        seqs.append(engine(*a, **k))
        return seqs[-1]
    pipeline.ar_generate = capture
    try:
        rec = serve(tts, "int8 AR (quantize_codeclm, weight-only) + int8 NAR", *ENTRY_REQUEST,
                    want)
    finally:
        pipeline.ar_generate = engine
    vs, ve = tts._valid_window
    del tts, q_ar
    (seq, n_gen), = seqs
    gen = seq[len(seq) - n_gen:]
    if n_gen < 1 or not ((gen >= vs) & (gen < ve)).all():
        raise RuntimeError(f"phase 7 (d): {int(((gen < vs) | (gen >= ve)).sum())} of {n_gen} "
                           f"generated tokens outside the vocabulary window [{vs}, {ve})")
    bf16 = next(r for r in records if r["path"] == "bf16 AR + int8 NAR")
    rec.update(quantize_s=quant_s, bf16_ar_ms_per_token=bf16["ar_ms_per_token"])
    print(f"phase 7 (d) int8 AR: quantize_codeclm {quant_s:.2f} s; {n_gen} tokens in "
          f"[{vs}, {ve}); AR {rec['ar_ms_per_token']:.2f} ms a token against "
          f"{bf16['ar_ms_per_token']:.2f} for phase 4's bf16 AR on the same request", flush=True)
    return rec


def entry_points(models, nar8, snap, records, serving):
    """Phase 7: the entry points from files on disk at the released widths.
    The files live in a temporary directory under ``build/`` that the
    phase removes, pass or fail."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    layers, ar_layers = snap["nar"][1].dec_layers, snap["ar"][1].n_layers
    no_modes = {"mha_int8": (0, 0), "fused_linear_grouped": (0, 0), "fused_ffn_grouped": (0, 0)}
    bf16_nar = {"mha": (layers * STEPS, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
                "heads_diffusion_tail": (0, 0), "diffusion_tail": (0, 0),
                "mega_decoder_stack": (0, 0), **no_modes}
    int8 = {**bf16_nar, "fused_linear": (2 * layers * STEPS, 2 * layers * STEPS),
            "fused_ffn": (layers * STEPS, layers * STEPS), "heads_diffusion_tail": (STEPS, STEPS)}
    mega = {**int8, "mha": (0, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
            "mega_decoder_stack": (STEPS, STEPS)}
    bf16_ar = {"fused_decode_layers": (0, 0), "head4_logits": (0, 0),
               "decode_attention": lambda n: (ar_layers * n, ar_layers * n)}
    fused_ar = {"fused_decode_layers": lambda n: (n, n), "head4_logits": (0, 0),
                "decode_attention": (0, 0)}
    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="phase7-", dir=ROOT / "build"))
    try:
        paths, files = write_entry_files(d, snap, models)
        recs = {"files": files}
        recs["cli"] = entry_cli(paths, models, {**bf16_nar, **bf16_ar})
        gc.collect()
        torch.cuda.empty_cache()
        recs.update(entry_predictor(paths, {**int8, **fused_ar}, {**mega, **fused_ar}, serving))
        gc.collect()
        torch.cuda.empty_cache()
        recs["int8_ar"] = entry_int8_ar(models, nar8, records, {**int8, **bf16_ar})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    recs["phase_s"] = time.perf_counter() - t0
    print(f"phase 7: entry points from files in {recs['phase_s']:.1f} s", flush=True)
    print(json.dumps({"entry_points": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                       if isinstance(v, dict) else v
                                       for k, v in recs.items()}}, default=str), flush=True)
    return recs


# -- 8. kernel K10 and the DeepSeek-V2-Lite AR (``portbench/configs``' widths)
DSV2LITE_CONFIG = ROOT / "portbench" / "configs" / "mars5-dsv2lite.json"
K10_ROWS = (1, 8)
K10_ROUTES = 16                     # routings cycled through by the timed calls


def dsv2lite_config():
    """(the ``CodecLMConfig`` of the ``mars5-dsv2lite`` benchmark
    configuration, its ``Mars5TTS`` options)."""
    from mars5_tts_torch.models.ar import CodecLMConfig

    cfg = json.loads(DSV2LITE_CONFIG.read_text())
    opts = dict(cfg["options"])
    opts["guidance_interval"] = tuple(opts["guidance_interval"])
    opts["nar_sites"] = tuple(opts["nar_sites"])
    return CodecLMConfig(**cfg["ar"]), opts


def k10_ulps(got, want):
    """The largest difference of K10's output from its twin's, in ulps of
    the output dtype at the larger magnitude (``moe_decode.one_ulp``)."""
    from mars5_tts_torch.ops.kernels.moe_decode import one_ulp

    return float(((got.float() - want.float()).abs() / one_ulp(got, want)).max())


def check_moe_decode(cfg, dev):
    """K10 at ``cfg``'s expert widths (E experts of F over D, top k, the
    shared experts as one SwiGLU of n_shared x F) and 1 and 8 rows, routed
    by a softmax over random gate weights: against its twin within one ulp
    (``one_ulp``), then timed over ``K10_ROUTES`` routings drawn anew, so
    that each call finds its experts cold in L2. The bound is the bytes of
    the distinct experts the routings pick, the shared pair, x, the routing
    and the output over 3.35 TB/s, against the operations at the bf16 peak."""
    import torch
    from mars5_tts_torch.ops.kernels import moe_decode as K

    e, f, d, k = cfg.n_routed_experts, cfg.moe_hidden_dim, cfg.dim, cfg.n_experts_per_tok
    fs = cfg.n_shared_experts * f
    g = own_generator(dev, 40)

    def u(*shape, fan):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * fan ** -0.5).to(
            torch.bfloat16)

    w13, w2 = u(e, 2 * f, d, fan=d), u(e, d, f, fan=f)
    shared = (u(fs, d, fan=d), u(fs, d, fan=d), u(d, fs, fan=fs))
    gate = u(e, d, fan=d).float()
    out = {}
    for rows in K10_ROWS:
        xs, routes = [], []
        for _ in range(K10_ROUTES):
            x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
            w, ids = torch.topk(torch.softmax(x.float() @ gate.t(), dim=-1), k, dim=-1)
            xs.append(x)
            routes.append((ids.to(torch.int32).contiguous(), w.contiguous()))
        worst, err, equal = 0.0, 0.0, 0
        for x, (ids, w) in zip(xs, routes):
            got = K.moe_decode(x, ids, w, w13, w2, *shared)
            want = K.moe_decode_ref(x, ids, w, w13, w2, *shared)
            worst = max(worst, k10_ulps(got, want))
            err = max(err, float((got.float() - want.float()).abs().max()))
            equal += int((got == want).sum())
        if worst > 1.0:
            raise RuntimeError(f"moe_decode ({rows} rows): {worst:.2f} ulps from its twin, "
                               "more than one")
        it = iter(range(10 ** 9))

        def call():
            i = next(it) % K10_ROUTES
            return K.moe_decode(xs[i], *routes[i], w13, w2, *shared)

        def plain():
            i = next(it) % K10_ROUTES
            return K.moe_decode_ref(xs[i], *routes[i], w13, w2, *shared)

        distinct = sum(len(torch.unique(ids)) for ids, _ in routes) / K10_ROUTES
        moved = (2 * 3 * d * (distinct * f + fs) + nbytes(xs[0], *routes[0], xs[0]))
        ops = 2 * 3 * d * (rows * k * f + rows * fs)
        bound_ms, bound_by = bound(moved, bf16=ops)
        st = {"rows": rows, "max_ulps": worst, "exact_frac": equal / (K10_ROUTES * rows * d),
              "distinct_experts": distinct, "max_abs_err": err,
              "ms": cuda_ms(call), "plain_ms": cuda_ms(plain, n=5, warmup=1),
              "device_ms": device_ms(call), "host_ms": host_ms(call),
              "bound_ms": bound_ms, "bound_by": bound_by, "bound_mb": moved / 1e6}
        st["share_of_bound"] = (None if st["device_ms"] is None
                                else st["bound_ms"] / st["device_ms"])
        out[rows] = st
        print(f"moe_decode ({rows} rows of {d}, {e} experts of {f}, top {k}, shared {fs}): "
              f"{worst:.2f} ulps from its twin ({st['exact_frac']:.4f} exact), "
              f"{fmt_us(st['ms'])} (device {fmt_us(st['device_ms'])}, host "
              f"{fmt_us(st['host_ms'])}, twin {fmt_us(st['plain_ms'])}), bound "
              f"{fmt_us(bound_ms)} ({st['bound_mb']:.1f} MB, {distinct:.2f} distinct experts)",
              flush=True)
    return out


def serve_dsv2lite(models, nar8, dev):
    """Phase 8 (b): the ``mars5-dsv2lite`` AR (its widths and depth, bf16,
    seeded random weights) as ``Mars5TTS``'s AR with the configuration's
    options beside phase 4's int8 NAR, serving one deep-clone request of
    ``serve``: K10 13 launches a decode step (one an expert layer, counted
    from 0 just before the call; the step graphed), K7 and K2 none. Then
    the same request again with the step eager and every K10 call held
    against its twin within one ulp: its grid equal to the graphed run's."""
    import torch
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models import ar as A
    from mars5_tts_torch.models import ar_graphs as G
    from mars5_tts_torch.models.ar import CodecLM
    from mars5_tts_torch.models.layers import init_params_
    from mars5_tts_torch.ops.kernels import moe_decode as K

    cfg, opts = dsv2lite_config()
    with torch.device("meta"):
        ar = CodecLM(cfg).to(torch.bfloat16)
    ar = ar.to_empty(device=dev)
    init_params_(ar, own_generator(dev, 41),
                 embedding_names=("embed.", "ref_chunked_emb.", "spk_identity_emb."))
    ar.requires_grad_(False).eval()
    common = {k: models[k] for k in ("texttok", "speechtok", "encodec", "vocos")}
    tts = Mars5TTS.from_params(ar, nar8, **common, **opts)
    experts = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    want = {"moe_decode": lambda n: (experts * n, experts * n), "decode_attention": (0, 0),
            "fused_decode_layers": (0, 0), "head4_logits": (0, 0)}
    req = ("The quick brown fox jumps over the lazy dog.", "A reference voice.", 11)
    torch.cuda.reset_peak_memory_stats(dev)
    label = f"dsv2lite AR ({cfg.n_layers} layers, bf16, graphed) + int8 NAR"
    rec = serve(tts, label, *req, want)
    grid = torch.as_tensor(tts.last_grid).clone()
    held = {"calls": 0, "elements_differ": 0, "max_ulps": 0.0}
    real = A.moe_decode

    def hold(x, ids, w, *weights, load=None):
        y = real(x, ids, w, *weights, load=load)
        ref = K.moe_decode_ref(x, ids, w, *weights)
        held["calls"] += 1
        held["elements_differ"] += int((y != ref).sum())
        held["max_ulps"] = max(held["max_ulps"], k10_ulps(y, ref))
        return y

    takes = G.takes
    A.moe_decode, G.takes = hold, (lambda state, route: False)
    try:
        eager = serve(tts, label.replace("graphed", "eager, K10 held"), *req, want)
    finally:
        A.moe_decode, G.takes = real, takes
    if held["max_ulps"] > 1.0:
        raise RuntimeError(f"{label}: a K10 call {held['max_ulps']:.2f} ulps from its twin")
    if held["calls"] != eager["launches"]["moe_decode"]:
        raise RuntimeError(f"{label}: {held['calls']} K10 calls held, "
                           f"{eager['launches']['moe_decode']} launched")
    if not torch.equal(torch.as_tensor(tts.last_grid), grid):
        raise RuntimeError(f"{label}: the eager step's grid differs from the graphed step's")
    out = {"graphed": rec, "eager_held": {**held, "ar_ms_per_token": eager["ar_ms_per_token"]},
           "k10_launches_per_decode_step": experts}
    print(f"{label}: {held['calls']} K10 calls held against the twin (max "
          f"{held['max_ulps']:.2f} ulps, {held['elements_differ']} elements differ); "
          f"graphed {rec['ar_ms_per_token']:.2f} ms/token, eager "
          f"{eager['ar_ms_per_token']:.2f}", flush=True)
    del tts, ar
    gc.collect()
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
