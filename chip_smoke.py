#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``mars5_tts_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compiles the six CUDA libraries from ``mars5_tts_torch/csrc`` for
   sm_90a into ``build/kernels/``, one nvcc each, all at once
   (``ops/kernels/build.build_all``).
3. Kernels against their plain PyTorch twins on the card, at the main paths'
   shapes, with stated error bounds and CUDA-event timings: K1 attention
   (beside ``scaled_dot_product_attention`` as a yardstick the port never
   calls), K3 fused_linear (qkv, caq and residual variants), K4 fused_ffn, K6
   heads_diffusion_tail (w = 3, at t = 0 and a middle t), K5 diffusion_tail
   (index-identical to K6 and to its twin), K2 fused_decode_layers (W8 and
   W4 at the released AR widths, window 2001, positions 600 and 1900), K8
   head4_logits (1536 -> 24,000) and K9 mega_decoder_stack (the int8 NAR
   decoder's 16 layers at the smoke request's shape: the first and the last
   layer alone for the exactly-equal share, then all sixteen).
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
   in place of K6). Each request's launch counts are reset before it and
   read after it.

Every kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over the H100 SXM peak for their type
(int8 1,979 TOP/s, bf16 989 TFLOP/s), from the inputs of this run.

Prints one JSON line with the kernels' results, then as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing a result.
"""

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
GEN_LEN, LANES, CLASSES = 750, 7, 1025
AR_MAX_LEN = 2000                   # K2 check: window min(3000, 2001)
AR_POSITIONS = (600, 1900)
HBM_BYTES_S = 3.35e12               # H100 SXM data sheet
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
# K9 at the smoke request's shape: 7 s reference = 525 prompt frames + up to
# 200 generated, two CFG rows; 66 encoder tokens (the deep-clone text + speaker)
MEGA_L, MEGA_LK = 725, 66


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
        tol = K.bf16_row_bound(ref)
        bound_txt = "2 bf16 ulp of each row's peak"
    else:
        tol = torch.full_like(diff, 1e-5) * ref.float().abs().max().clamp_min(1.0)
        bound_txt = "1e-5 x max(1, peak)"
    ok = bool((diff <= tol).all())
    res = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "ms": cuda_ms(lambda: K.mha(q, k, v, mask)),
           "plain_ms": cuda_ms(lambda: K.mha_ref(q, k, v, mask))}
    keys = l * b if mask is None else int((~mask).sum())
    res["bound_ms"], res["bound_by"] = bound(nbytes(q, k, v, out, mask),
                                             bf16=4 * h * l * d * keys)
    if dtype == torch.bfloat16:     # the library yardstick, never called by the port
        import torch.nn.functional as Fn
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = None if mask is None else ~mask[:, None, None, :]
        res["library_ms"] = cuda_ms(lambda: Fn.scaled_dot_product_attention(qt, kt, vt, am))
    print(f"K1 {tuple(shape)} {str(dtype).split('.')[-1]} mask={masked}: "
          f"max_abs_err={res['max_abs_err']:.3e} mean_abs_err={res['mean_abs_err']:.3e} "
          f"bound={bound_txt} (max {tol.max().item():.3e}) within={ok} | "
          f"kernel {res['ms'] * 1e3:.1f} us, plain {res['plain_ms'] * 1e3:.1f} us, "
          f"sdpa {res.get('library_ms', float('nan')) * 1e3:.1f} us, roofline "
          f"{res['bound_ms'] * 1e3:.1f} us ({res['bound_by']})", flush=True)
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


def check_w8a8(name, run, twin, moved, int8_ops):
    """One K3/K4 variant against its twin, with CUDA-event times; ``moved``
    the bytes it must move, ``int8_ops`` its operations."""
    import torch
    out = run()
    ref = twin()
    torch.cuda.synchronize()
    ok, st = fused_bound(out, ref)
    st.update(ms=cuda_ms(run), plain_ms=cuda_ms(twin))
    st["bound_ms"], st["bound_by"] = bound(moved + nbytes(out), int8=int8_ops)
    print(f"{name}: max_abs_err={st['max_abs_err']:.3e} mean_abs_err={st['mean_abs_err']:.3e} "
          f"exact={st['exact_frac']:.4f} bound=fused_eq(0.02 peak, >95% exact, mean<2e-3 peak) "
          f"within={ok} | kernel {st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} us, "
          f"roofline {st['bound_ms'] * 1e3:.1f} us ({st['bound_by']})", flush=True)
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
        lambda: F.fused_linear_ref(x, qkv_w, ln=ln, bias=qkv_b),
        nbytes(x, *qkv_w, qkv_b, *ln), 2 * M_ROWS * 3 * DIM * DIM)
    res["caq"] = check_w8a8(
        "K3 caq (2, 1200, 1024) -> 1024, LN + bias",
        lambda: F.fused_linear(x, sq_w, ln=ln, bias=sq_b),
        lambda: F.fused_linear_ref(x, sq_w, ln=ln, bias=sq_b),
        nbytes(x, *sq_w, sq_b, *ln), 2 * M_ROWS * DIM * DIM)
    a = (x * 0.5).contiguous()
    res["residual"] = check_w8a8(
        "K3 residual (2, 1200, 1024) -> 1024, bias + residual",
        lambda: F.fused_linear(a, sq_w, bias=sq_b, residual=x),
        lambda: F.fused_linear_ref(a, sq_w, bias=sq_b, residual=x),
        nbytes(a, *sq_w, sq_b, x), 2 * M_ROWS * DIM * DIM)
    w, v = rand_qweight(FFN, DIM, gen, dev), rand_qweight(FFN, DIM, gen, dev)
    l2 = rand_qweight(DIM, FFN, gen, dev)
    l2_b = 0.1 * torch.randn(DIM, generator=gen, device=dev)
    res["ffn"] = check_w8a8(
        "K4 ffn (2, 1200, 1024), F 3072",
        lambda: F.fused_ffn(x, ln, w, v, l2, l2_b),
        lambda: F.fused_ffn_ref(x, ln, w, v, l2, l2_b),
        nbytes(x, *ln, *w, *v, *l2, l2_b), 2 * M_ROWS * 3 * DIM * FFN)
    return res


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
        st = {"mismatches": int(mism.sum()), "near_ties": int(near_tie.sum()),
              "max_abs_err": shortfall.max().item(),
              "ms": cuda_ms(lambda: D.heads_diffusion_tail(*args, w=3.0, temp=0.7)),
              "plain_ms": cuda_ms(lambda: D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7))}
        print(f"K6 heads+tail (2, 750, 1024) x (7, 1025) w=3 t={t}: index mismatches "
              f"{st['mismatches']} of {got.numel()} (twin near-ties within 1e-5: "
              f"{st['near_ties']}, mismatches outside them: {bad}) | kernel "
              f"{st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} us", flush=True)
        st["bound_ms"], st["bound_by"] = bound(
            nbytes(x8, xs, *folded.values(), u0, x_t, scal, got),
            int8=2 * x8.shape[0] * GEN_LEN * LANES * CLASSES * DIM)
        if bad or got.min() < 0 or got.max() >= CLASSES:
            raise RuntimeError(f"K6 t={t}: indices differ from the twin outside near-ties")
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
               "heads_ms": cuda_ms(lambda: nar_heads_folded(folded, out))}
        st5["bound_ms"], st5["bound_by"] = bound(nbytes(*tail_args, got5))
        print(f"K5 tail (2, 750, 7, 1025) bf16 logits w=3 t={t}: index mismatches against "
              f"K6 {st5['vs_k6']}, against its twin {st5['vs_twin']} of {got5.numel()} "
              f"(bound: 0) | kernel {st5['ms'] * 1e3:.1f} us, plain {st5['plain_ms'] * 1e3:.1f} "
              f"us, roofline {st5['bound_ms'] * 1e3:.1f} us ({st5['bound_by']}); the folded "
              f"heads before it (torch._int_mm + epilogue) {st5['heads_ms'] * 1e3:.1f} us",
              flush=True)
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
            st.update(ms=cuda_ms(lambda: D.fused_decode_layers(*args, dims=dims, norm_eps=eps),
                                 n=50),
                      plain_ms=cuda_ms(lambda: D.fused_step_ref(*args, dims=dims, norm_eps=eps),
                                       n=5, warmup=1),
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
                  f"fraction (f32) within={ok} | kernel {st['ms'] * 1e3:.1f} us, plain "
                  f"{st['plain_ms'] * 1e3:.1f} us; pack {st['pack_mb']:.1f} MB -> "
                  f"{st['pack_gb_s']:.0f} GB/s ({100 * st['pack_gb_s'] * 1e9 / HBM_BYTES_S:.1f}% "
                  f"of 3.35 TB/s)", flush=True)
            if not ok:
                raise RuntimeError(f"K2 W{wbits} pos={pos}: error above its bound")
            res[(wbits, pos)] = st
        del fp, ck, cv, kvs
    return res


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
    st = {"max_abs_err": err, "exact": bool(torch.equal(got, want)),
          "ms": cuda_ms(lambda: H.head4_logits(x, wp, ws, n_vocab=n), n=50),
          "plain_ms": cuda_ms(lambda: H.head4_logits_ref(x, wp, ws, n_vocab=n), n=20)}
    nbytes = wp.numel() + ws.numel() * 4
    st["bound_ms"], st["bound_by"] = bound(nbytes + x.numel() * 2 + n * 4, int8=2 * n * x.shape[1])
    print(f"K8 head4 (1, {ar.cfg.dim}) -> {n}: max_abs_err={err:.3e} (bitwise equal: "
          f"{st['exact']}) bound=1e-5 x peak ({1e-5 * peak:.3e}) within={err <= 1e-5 * peak} | "
          f"kernel {st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} us; "
          f"{nbytes / 1e6:.1f} MB -> {nbytes / (st['ms'] * 1e-3) / 1e9:.0f} GB/s", flush=True)
    if not err <= 1e-5 * peak:
        raise RuntimeError("K8: error above its bound")
    return st


def check_mega(dec, gen, dev):
    """K9 on the int8 NAR decoder (16 x 1024, F 3072) at the smoke request's
    shape, both key-padding masks on: the first layer and the last layer
    alone against the twin within the JAX kernel tests' fused bound, with the
    exactly-equal share of their bf16 outputs reported (>= 99.9% expected, as
    K3/K4 reach; the last layer checks the per-layer offsets into the pack
    and the scale, bias and LN vectors), then all sixteen within 0.03 x
    max|twin| and a mean error below 8e-3 x max|twin|
    (tests/test_nar_mega.py, tests/test_torch_nar_mega.py)."""
    import dataclasses

    import torch
    from mars5_tts_torch.ops.kernels import nar_mega as M

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

    one, last = layer(0), layer(d.n_layers - 1)
    ok1, st1 = fused_bound(M.mega_decoder_stack(one, x, mem, tm, mm),
                           M.mega_decoder_stack_ref(one, x, mem, tm, mm))
    ok_last, st_last = fused_bound(M.mega_decoder_stack(last, x, mem, tm, mm),
                                   M.mega_decoder_stack_ref(last, x, mem, tm, mm))
    # the same layer with two of its three residual branches zeroed: which
    # segment's sums part kernel and twin
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
    ok = (bool(torch.isfinite(got).all()) and diff.max().item() <= 0.03 * peak
          and diff.mean().item() <= 8e-3 * peak)
    st = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
          "exact_frac": (got == want).float().mean().item(), "one_layer": st1,
          "last_layer": st_last,
          "ms": cuda_ms(lambda: M.mega_decoder_stack(mp, x, mem, tm, mm), n=10, warmup=2),
          "plain_ms": cuda_ms(lambda: M.mega_decoder_stack_ref(mp, x, mem, tm, mm), n=3,
                              warmup=1),
          "kernels_per_call": 1 + 9 * d.n_layers}
    rows, mk = 2 * MEGA_L, 2 * MEGA_LK
    D, F = d.dim, d.hidden
    int8_ops = d.n_layers * (2 * rows * (6 * D * D + 3 * F * D) + 2 * mk * 2 * D * D)
    flops = d.n_layers * 4 * d.nhead * MEGA_L * d.head_dim * (int((~tm).sum()) + int((~mm).sum()))
    st["bound_ms"], st["bound_by"] = bound(
        nbytes(x, mem, tm, mm, mp.pack, mp.svec, mp.bvec, mp.lnvec, got), int8=int8_ops,
        bf16=flops)
    st["phase_ms"] = mega_phases(lambda: M.mega_decoder_stack(mp, x, mem, tm, mm),
                                 d.n_layers)
    print(f"K9 mega_decoder_stack (2, {MEGA_L}, {D}) over memory (2, {MEGA_LK}, {D}), "
          f"{d.n_layers} x (F {F}), masks on: layer 0 alone max_abs_err="
          f"{st1['max_abs_err']:.3e} exact={st1['exact_frac']:.5f} bound=fused_eq within={ok1}; "
          f"layer {d.n_layers - 1} alone max_abs_err={st_last['max_abs_err']:.3e} "
          f"exact={st_last['exact_frac']:.5f} bound=fused_eq within={ok_last}; {d.n_layers} "
          f"layers max_abs_err={st['max_abs_err']:.3e} mean_abs_err={st['mean_abs_err']:.3e} "
          f"(peak {peak:.3f}) exact={st['exact_frac']:.4f} bound=0.03 x peak, mean <= 8e-3 x "
          f"peak within={ok} | kernel {st['ms']:.3f} ms "
          f"({st['kernels_per_call']} launches from one C call), plain {st['plain_ms']:.3f} ms, "
          f"roofline {st['bound_ms']:.3f} ms ({st['bound_by']}); pack "
          f"{mp.pack.numel() / 1e6:.1f} MB", flush=True)
    print("K9 one layer, exactly-equal share with two residual branches zeroed: "
          + json.dumps(st1["segments_exact"]) + "; device time by phase over one call "
          "(torch.profiler, ms): " + json.dumps(st["phase_ms"]), flush=True)
    if not (ok1 and ok_last and ok):
        raise RuntimeError("K9: error above its bound")
    return st


MEGA_PHASES = ("qkv", "self-attention", "sa_out", "ca_q", "ca_kv", "cross-attention", "ca_out",
               "WV", "lin2")


def mega_phases(run, n_layers):
    """Device ms of each K9 phase summed over the layers of one call, from
    the profiler's kernel records in launch order (the memory quant, then
    nine a layer); None when the profiler records no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if any(k in e.name for k in ("w8a8_gemm_kernel", "attn_kernel",
                                                "quant_rows_kernel"))),
                  key=lambda e: e.time_range.start)
    if len(kern) != 1 + len(MEGA_PHASES) * n_layers:
        return None
    out = {"memory quant": kern[0].time_range.elapsed_us() / 1e3}
    for i, e in enumerate(kern[1:]):
        name = MEGA_PHASES[i % len(MEGA_PHASES)]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
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
    from mars5_tts_torch.ops.kernels import (decode_layer as L, diffusion_tail as D,
                                             head4 as H, mha as K, nar_fused as F,
                                             nar_mega as M)
    return {"mha": K.launch_count, "fused_linear": F.fused_linear_launches,
            "fused_ffn": F.fused_ffn_launches, "heads_diffusion_tail": D.launch_count,
            "diffusion_tail": D.tail_launch_count, "mega_decoder_stack": M.launch_count,
            "fused_decode_layers": L.launch_count, "head4_logits": H.launch_count}


def reset_counts():
    from mars5_tts_torch.ops.kernels import (decode_layer as L, diffusion_tail as D,
                                             head4 as H, mha as K, nar_fused as F,
                                             nar_mega as M)
    K.reset_launch_count()
    F.reset_launch_counts()
    D.reset_launch_count()
    L.reset_launch_count()
    H.reset_launch_count()
    M.reset_launch_count()


AR_RUNS = []


def record_ar(fn):
    """``fn`` (an AR engine) that also records each run's sequence length,
    n_generated and max_len, for the launch and ms-per-token checks."""
    def run(*args, sampling, **kw):
        seq, n_gen = fn(*args, sampling=sampling, **kw)
        AR_RUNS.append((len(seq), n_gen, sampling.max_len))
        return seq, n_gen
    return run


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
    (seq_len, n_gen, max_len), = AR_RUNS
    steps = n_gen - (seq_len >= max_len)     # a decode step follows every token but a last one at max_len
    want = {k: (v(steps) if callable(v) else v) for k, v in want.items()}
    if not (len(audio) > 0 and np.isfinite(audio).all()):
        raise RuntimeError(f"{label}: tts produced empty or non-finite audio")
    if not (int(grid.min()) >= 0 and int(grid.max()) <= 1024):
        raise RuntimeError(f"{label}: grid codes outside [0, 1024]")
    for name, (lo, hi) in want.items():
        if not lo <= launches[name] <= hi:
            raise RuntimeError(f"{label}: {name} launched {launches[name]} times, "
                               f"expected {lo}..{hi}")
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
    libs = build.build_all()
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
    k6, k5 = check_heads_tail(gen, dev)
    models = build_models(dev, torch)
    k2 = check_decode_layer(models["ar"], gen, dev)
    k8 = check_head4(models["ar"], gen, dev)

    # -- 4. main paths, each request with its launch counts from 0
    records, main_launches, path_launches, nar8 = serve_paths(models, dev)
    # K9 on the served NAR's own int8 decoder weights
    k9 = check_mega(nar8.tfm.decoder, gen, dev)
    if any(m.split(".")[0] in ("jax", "mars5_tts_tpu") for m in sys.modules):
        raise RuntimeError("the port pulled in jax or the JAX package")

    def row(name, source, replaces, st, launches=None):
        return {"name": name, "route": "cuda", "source": f"mars5_tts_torch/csrc/{source}",
                "replaces": replaces,
                "launches": main_launches[name] if launches is None else launches,
                "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": st.get("library_ms")}

    k6_worst = max(k6, key=lambda st: st["max_abs_err"])
    k2_main = k2[(4, AR_POSITIONS[0])]
    print(json.dumps({"kernels": [
        {**row("mha", "mha.cu", "mars5_tts_tpu/ops/pallas/mha.py:46", main_res),
         "max_abs_err": max(main_res["max_abs_err"], second["max_abs_err"])},
        {**row("fused_decode_layers", "decode_layer.cu",
               "mars5_tts_tpu/ops/pallas/decode_layer.py:139", k2_main),
         "max_abs_err": max(st["max_abs_err"] for st in k2.values())},
        {**row("fused_linear", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:111",
               w8a8["qkv"]),
         "max_abs_err": max(w8a8[v]["max_abs_err"] for v in ("qkv", "caq", "residual"))},
        row("fused_ffn", "nar_fused.cu", "mars5_tts_tpu/ops/pallas/nar_fused.py:144",
            w8a8["ffn"]),
        {**row("heads_diffusion_tail", "diffusion_tail.cu",
               "mars5_tts_tpu/ops/pallas/diffusion_tail.py:149", k6[-1]),
         "max_abs_err": k6_worst["max_abs_err"]},
        row("head4_logits", "head4.cu", "mars5_tts_tpu/ops/pallas/head4.py:55", k8,
            launches=path_launches["head4_logits"]),
        row("diffusion_tail", "diffusion_tail.cu",
            "mars5_tts_tpu/ops/pallas/diffusion_tail.py:41", k5[-1],
            launches=path_launches["diffusion_tail"]),
        row("mega_decoder_stack", "nar_mega.cu", "mars5_tts_tpu/ops/pallas/nar_mega.py:251", k9,
            launches=path_launches["mega_decoder_stack"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_paths(models, dev):
    """Phase 4: every path's requests (the bf16 NAR leaves ``models`` once it
    is quantized). Returns (records, the launches of the production requests
    (fused4 AR + int8 NAR) by kernel, the launches of K8, K5 and K9 on the
    requests of their own paths, the int8 NAR)."""
    import torch

    import mars5_tts_torch.pipeline as pipeline
    from mars5_tts_torch import Mars5TTS
    pipeline.ar_generate = record_ar(pipeline.ar_generate)
    pipeline.ar_generate_fused = record_ar(pipeline.ar_generate_fused)
    ar, nar = models["ar"], models.pop("nar")
    common = {k: models[k] for k in ("texttok", "speechtok", "encodec", "vocos")}
    layers = nar.cfg.dec_layers
    k1_only = {"mha": (layers * STEPS, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
               "heads_diffusion_tail": (0, 0), "diffusion_tail": (0, 0),
               "mega_decoder_stack": (0, 0)}
    int8 = {"mha": (layers * STEPS, 10 ** 9),
            "fused_linear": (2 * layers * STEPS, 2 * layers * STEPS),
            "fused_ffn": (layers * STEPS, layers * STEPS),
            "heads_diffusion_tail": (STEPS, STEPS), "diffusion_tail": (0, 0),
            "mega_decoder_stack": (0, 0)}
    # K9 in place of the decoder's K1, K3 and K4; K5 in place of K6
    mega = {**int8, "mha": (0, 10 ** 9), "fused_linear": (0, 0), "fused_ffn": (0, 0),
            "mega_decoder_stack": (STEPS, STEPS)}
    split = {**int8, "heads_diffusion_tail": (0, 0), "diffusion_tail": (STEPS, STEPS)}
    bf16_ar = {"fused_decode_layers": (0, 0), "head4_logits": (0, 0)}
    fused_ar = {"fused_decode_layers": lambda n: (n, n), "head4_logits": (0, 0)}
    head4_ar = {"fused_decode_layers": lambda n: (n, n), "head4_logits": lambda n: (n, n)}
    first = ("The quick brown fox jumps over the lazy dog.", "A reference voice.", 11)
    second_req = ("Hello from the port of the speech model.", "Another sample here.", 12)
    torch.cuda.reset_peak_memory_stats(dev)
    records = [serve(Mars5TTS.from_params(ar, nar, **common), "bf16 AR + bf16 NAR", *first,
                     {**k1_only, **bf16_ar})]
    t0 = time.perf_counter()
    nar8 = Mars5TTS.from_params(ar, nar, nar_backend="int8", **common).codecnar
    torch.cuda.synchronize()
    print(f"quantize_nar: {time.perf_counter() - t0:.2f} s", flush=True)
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
    print(json.dumps({"requests": records}), flush=True)
    bf16_ms = records[1]["ar_ms_per_token"]
    print("AR stage ms/token (same call, incl. prefill): " + ", ".join(
        f"{r['path']}: {r['ar_ms_per_token']:.2f}" for r in records)
        + f"; fused4 / bf16 AR = {records[3]['ar_ms_per_token'] / bf16_ms:.3f}", flush=True)
    return records, main_launches, path_launches, nar8


if __name__ == "__main__":
    sys.exit(main())
