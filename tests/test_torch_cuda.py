"""Kernel checks that need an NVIDIA GPU (marker ``cuda``; skipped without one).

Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``.
Each CUDA kernel is held against its plain PyTorch twin on the same inputs.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape_q, lk, dtype, dev, seed):
    b, lq, h, d = shape_q
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, lq, h, d), np.float32) * 2)
    k = torch.from_numpy(rng.standard_normal((b, lk, h, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, lk, h, d), np.float32))
    return [x.to(dev, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("b,lq,lk,h,dtype,masked", [
    (2, 1200, 1200, 16, torch.bfloat16, True),    # NAR self-attention
    (2, 525, 525, 16, torch.bfloat16, False),
    (1, 526, 526, 24, torch.bfloat16, True),      # AR speaker encoder
    (1, 130, 70, 2, torch.bfloat16, True),        # cross shape, ragged tiles
    (2, 77, 77, 3, torch.float32, True),
    (1, 600, 333, 4, torch.float32, False),
])
def test_mha_kernel_matches_ref(dev, b, lq, lk, h, dtype, masked):
    from mars5_tts_torch.ops.kernels import mha as K

    q, k, v = _qkv((b, lq, h, 64), lk, dtype, dev, seed=lq + lk)
    mask = None
    if masked:
        mask = torch.zeros((b, lk), dtype=torch.bool, device=dev)
        mask[-1, lk - lk // 5:] = True
        mask[0, 3] = True
    n0 = K.launch_count
    out = K.mha(q, k, v, mask)
    torch.cuda.synchronize()
    assert K.launch_count == n0 + 1
    ref = K.mha_ref(q, k, v, mask)
    err = (out.float() - ref.float()).abs()
    # bf16: the kernel's stated bound; f32: sum order only
    bound = (K.bf16_row_bound(ref) if dtype == torch.bfloat16
             else 1e-5 * max(1.0, ref.float().abs().max().item()))
    assert torch.isfinite(out).all()
    assert bool((err <= bound).all()), err.max().item()


def test_mha_kernel_reads_strided_views(dev):
    """q/k/v sliced out of one fused projection are read in place."""
    from mars5_tts_torch.ops.kernels import mha as K

    b, l, h, d = 2, 530, 16, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, l, 3, h * d), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(b, l, h, d) for i in range(3))
    out = K.mha(q, k, v)
    ref = K.mha_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert bool(((out.float() - ref.float()).abs() <= K.bf16_row_bound(ref)).all())


def test_mha_kernel_rejects_other_head_dims(dev):
    from mars5_tts_torch.ops.kernels import mha as K

    q = torch.zeros((1, 8, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.mha(q, q, q)


def test_nar_trajectory_on_gpu_matches_cpu(dev):
    """A small f32 NAR (head_dim 64) over a >= 512-frame deep-clone sequence:
    on the card its decoder self-attention runs K1; with the same weights,
    uniforms and initial noise the grid equals the CPU run's."""
    import copy

    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.diffusion.schedule import build_step_plan
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels import mha as K

    cfg = ResidualTransformerConfig(n_text_vocab=64, dim=128, nhead=2, enc_layers=1,
                                    dec_layers=2, n_spk_layers=1, t_emb_dim=64,
                                    hidden_dim=256)
    cpu = ResidualTransformer(cfg).init_(torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    T, lc, lx = 3, 500, 30
    r = np.random.default_rng(0)
    x = np.repeat(r.integers(0, 1024, lx)[None, :, None], 8, axis=2)
    batch = (r.integers(0, 64, (1, 9)), r.integers(0, 1024, (1, lc, 8)), np.asarray([9]),
             np.asarray([lc]), x, np.zeros((1, lx), bool))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=1)
    u = r.random((len(build_step_plan(T)[0]), 2, 1, lc + lx, 8, 1025)).astype(np.float32)
    x_init = r.integers(0, 1025, x.shape)
    want = perform_simple_inference(cpu, batch, MultinomialDiffusion(1025, T), T, dsh,
                                    uniforms=u, x_init=x_init)
    n0 = K.launch_count
    got = perform_simple_inference(gpu, batch, MultinomialDiffusion(1025, T, device=dev),
                                   T, dsh, uniforms=u, x_init=x_init)
    torch.cuda.synchronize()
    assert K.launch_count - n0 == cfg.dec_layers * T
    assert torch.equal(got.cpu(), want)


def test_ar_generate_on_gpu_matches_cpu(dev):
    """A small f32 AR whose speaker encoder (head_dim 64) sees 520 frames and so
    runs K1 on the card: same tokens as on the CPU under the same uniforms."""
    import copy

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.ops.kernels import mha as K

    cfg = CodecLMConfig(n_vocab=1283, dim=128, n_heads=2, n_kv_heads=2, head_dim=64,
                        n_layers=2, hidden_dim=256, sliding_window=3000,
                        n_spk_layers=2, spk_hidden_dim=256)
    cpu = CodecLM(cfg).init_(torch.Generator().manual_seed(1)).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(1)
    spk = r.integers(0, 1024, (520, 8))
    prompt = np.concatenate([r.integers(0, 258, 10), spk[:40, 0] + 258])
    s = ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283,
                   max_len=len(prompt) + 60)
    u = r.random(s.max_len).astype(np.float32)
    want = ar_generate(cpu, prompt, spk, sampling=s, uniforms=u)
    n0 = K.launch_count
    got = ar_generate(gpu, prompt, spk, sampling=s, uniforms=u)
    assert K.launch_count - n0 == cfg.n_spk_layers
    np.testing.assert_array_equal(got[0], want[0])


def _fused_eq(got, want, exact_frac=0.95):
    """The JAX kernel tests' bound (tests/test_nar_fused.py _assert_fused_eq)."""
    g, w = got.float(), want.float()
    peak = max(w.abs().max().item(), 1.0)
    d = (g - w).abs()
    assert torch.isfinite(g).all()
    assert d.max().item() <= 0.02 * peak, d.max().item()
    assert (g == w).float().mean().item() > exact_frac
    assert d.mean().item() < 2e-3 * peak


def _qw(n, k, g, dev):
    from mars5_tts_torch.ops.quant import quantize_weight
    return quantize_weight(torch.randn((n, k), generator=g, device=dev) * 0.05)


@pytest.mark.parametrize("m,k,n,variant", [(300, 256, 192, "ln_bias"), (70, 1024, 3072, "ln_bias"),
                                           (2400, 1024, 1024, "residual"), (17, 128, 64, "plain")])
def test_fused_linear_kernel_matches_ref(dev, m, k, n, variant):
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16)
    w = _qw(n, k, g, dev)
    kw = {}
    if variant == "ln_bias":
        kw = dict(ln=(1 + 0.1 * torch.randn(k, generator=g, device=dev),
                      0.1 * torch.randn(k, generator=g, device=dev)),
                  bias=0.1 * torch.randn(n, generator=g, device=dev))
    elif variant == "residual":
        kw = dict(bias=0.1 * torch.randn(n, generator=g, device=dev),
                  residual=torch.randn((1, m, n), generator=g, device=dev).to(torch.bfloat16))
    n0 = F.fused_linear_launches
    out = F.fused_linear(x, w, **kw)
    torch.cuda.synchronize()
    assert F.fused_linear_launches == n0 + 1 and out.shape == (1, m, n)
    _fused_eq(out, F.fused_linear_ref(x, w, **kw))


@pytest.mark.parametrize("m,k,f", [(200, 256, 384), (2400, 1024, 3072)])
def test_fused_ffn_kernel_matches_ref(dev, m, k, f):
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((2, m // 2, k), generator=g, device=dev).to(torch.bfloat16)
    ln = (1 + 0.1 * torch.randn(k, generator=g, device=dev),
          0.1 * torch.randn(k, generator=g, device=dev))
    args = (x, ln, _qw(f, k, g, dev), _qw(f, k, g, dev), _qw(k, f, g, dev),
            0.1 * torch.randn(k, generator=g, device=dev))
    n0 = F.fused_ffn_launches
    out = F.fused_ffn(*args)
    torch.cuda.synchronize()
    assert F.fused_ffn_launches == n0 + 1
    _fused_eq(out, F.fused_ffn_ref(*args))


def test_w8a8_kernels_reject_what_they_do_not_take(dev):
    from mars5_tts_torch.ops.kernels import nar_fused as F

    x = torch.zeros((1, 8, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        F.fused_linear(x, _qw(100, 256, None, dev))          # N not a multiple of 64
    with pytest.raises(ValueError):
        F.fused_linear(x.float(), _qw(64, 256, None, dev))   # f32 activations
    with pytest.raises(ValueError):
        F.fused_linear(x[..., :200], _qw(64, 200, None, dev))  # K not a multiple of 128


@pytest.mark.parametrize("rows,length,t", [(2, 750, 0), (2, 70, 100), (1, 33, 199)])
def test_heads_tail_kernel_matches_ref(dev, rows, length, t):
    """Indices equal to the twin's except where its two best scores lie
    within 1e-5 of each other."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    g = torch.Generator(device=dev).manual_seed(rows * 1000 + length)
    d, n, kc = 1024, 7, 1025
    x8, xs = nar_heads_prequant(torch.randn((rows, length, d), generator=g,
                                            device=dev).to(torch.bfloat16))
    wf = torch.randn((n, kc, d), generator=g, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((n, kc), generator=g, device=dev)}
    u0 = torch.rand((1, length, n, kc), generator=g, device=dev)
    x_t = torch.randint(0, kc, (1, length, n), generator=g, device=dev)
    args = (x8, xs, folded, u0, x_t, D.tail_scalars(MultinomialDiffusion(kc, 200, device=dev), t))
    n0 = D.launch_count
    got = D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
    torch.cuda.synchronize()
    assert D.launch_count == n0 + 1
    want = D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)
    top2 = torch.topk(D.tail_scores(*args, w=3.0, temp=0.7), 2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 1e-5
    assert not bool(((got != want) & ~near_tie).any())


def test_w8a8_nar_trajectory_on_gpu(dev):
    """A small W8A8 NAR (head_dim 64) over a >= 512-frame deep-clone sequence:
    every reverse step runs K1, K3 (twice a layer), K4 and, on the generator
    path, K6 once. Under shared uniforms the GPU grid agrees with the CPU
    twins' on at least 96% of the cells (LN sum order may flip an int8
    activation, as between the port and the JAX package), and on the
    generator path the K6 route agrees with the dense route as closely."""
    import copy

    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.diffusion.schedule import build_step_plan
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels import diffusion_tail as D, mha as K, nar_fused as F
    from mars5_tts_torch.ops.quant import quantize_nar

    cfg = ResidualTransformerConfig(n_text_vocab=64, dim=128, nhead=2, enc_layers=1,
                                    dec_layers=2, n_spk_layers=1, t_emb_dim=64,
                                    hidden_dim=256)
    cpu = quantize_nar(ResidualTransformer(cfg).init_(torch.Generator().manual_seed(0))
                       .to(torch.bfloat16).eval())
    gpu = copy.deepcopy(cpu).to(dev)
    T, lc, lx = 3, 500, 30
    r = np.random.default_rng(0)
    x = np.repeat(r.integers(0, 1024, lx)[None, :, None], 8, axis=2)
    batch = (r.integers(0, 64, (1, 9)), r.integers(0, 1024, (1, lc, 8)), np.asarray([9]),
             np.asarray([lc]), x, np.zeros((1, lx), bool))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=1)
    u = r.random((len(build_step_plan(T)[0]), 2, 1, lc + lx, 8, 1025)).astype(np.float32)
    x_init = r.integers(0, 1025, x.shape)
    want = perform_simple_inference(cpu, batch, MultinomialDiffusion(1025, T), T, dsh,
                                    uniforms=u, x_init=x_init)
    n0 = (K.launch_count, F.fused_linear_launches, F.fused_ffn_launches, D.launch_count)
    got = perform_simple_inference(gpu, batch, MultinomialDiffusion(1025, T, device=dev),
                                   T, dsh, uniforms=u, x_init=x_init)
    torch.cuda.synchronize()
    n1 = (K.launch_count, F.fused_linear_launches, F.fused_ffn_launches, D.launch_count)
    L = cfg.dec_layers
    assert tuple(b - a for a, b in zip(n0, n1)) == (L * T, 2 * L * T, L * T, 0)
    assert (got.cpu() == want).float().mean().item() >= 0.96
    diff = MultinomialDiffusion(1025, T, device=dev)
    grids = []
    for route in ("heads", "dense"):
        k6 = D.launch_count
        grids.append(perform_simple_inference(
            gpu, batch, diff, T, dsh, generator=torch.Generator(device=dev).manual_seed(1),
            tail=route))
        assert D.launch_count - k6 == (T if route == "heads" else 0)
    assert (grids[0] == grids[1]).float().mean().item() >= 0.96


def _fused_eq_f32(got, want):
    """The JAX kernel tests' bound without its exact-fraction clause, for f32
    outputs: kernel and twin take their sums in f64 and agree bit for bit
    when the card's exp, sqrt and division round as PyTorch's kernels do
    (measured on an H100); a moved int8 rounding, which changes every later
    f32 value by a little, stays within 0.02 x peak, mean 2e-3 x peak."""
    g, w = got.float(), want.float()
    peak = max(w.abs().max().item(), 1.0)
    d = (g - w).abs()
    assert torch.isfinite(g).all()
    assert d.max().item() <= 0.02 * peak, d.max().item()
    assert d.mean().item() < 2e-3 * peak, d.mean().item()


def _decode_model(cfg, dev, seed):
    """A bf16 CodecLM on the card with seeded random weights."""
    from mars5_tts_torch.models.ar import CodecLM

    with torch.device(dev):
        return CodecLM(cfg).init_(torch.Generator(device=dev).manual_seed(seed)).to(
            torch.bfloat16).eval()


def _ring(dims, g, dev):
    """Random int8 K/V rings (L, window, d) with their per-position scales."""
    from mars5_tts_torch.ops.kernels.decode_layer import quantize_kv_rows

    shape = (dims.n_layers, dims.window, dims.dim)
    (ck, ks), (cv, vs) = (quantize_kv_rows(torch.randn(shape, generator=g, device=dev) * 0.1)
                          for _ in range(2))
    return ck, cv, torch.stack([ks, vs], dim=1).contiguous()


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("full", [False, True])
def test_fused_decode_kernel_matches_ref(dev, wbits, full):
    """K2 against ``fused_step_ref`` on the same pack, ring and token: at a
    small geometry before and after the ring wraps, and at the released
    widths (26 x 1536, 24 heads, hidden 3584, window 2001)."""
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    if full:
        cfg, max_len, positions = CodecLMConfig.mars5(24_000), 2000, (0, 600, 1900)
    else:
        cfg = CodecLMConfig(n_vocab=512, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            n_layers=3, hidden_dim=512, sliding_window=24)
        max_len, positions = 40, (0, 5, 30)
    fp, dims = prepare_fused(_decode_model(cfg, dev, wbits), max_len, wbits)
    g = torch.Generator(device=dev).manual_seed(wbits)
    ck, cv, kvs = _ring(dims, g, dev)
    for pos in positions:
        x = fp["embed"][pos + 7].to(torch.bfloat16)[None]
        n0 = D.launch_count
        got = D.fused_decode_layers(fp, x, pos, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
        torch.cuda.synchronize()
        assert D.launch_count == n0 + 1
        want = D.fused_step_ref(fp, x, pos, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _fused_eq_f32(a, b)


def test_fused_decode_kernel_rejects_what_it_does_not_take(dev):
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    cfg = CodecLMConfig(n_vocab=300, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=1, hidden_dim=512, sliding_window=24)
    fp, dims = prepare_fused(_decode_model(cfg, dev, 0), 40, 8)
    ck, cv, kvs = _ring(dims, None, dev)
    x = fp["embed"][:1].to(torch.bfloat16)
    with pytest.raises(ValueError):
        D.fused_decode_layers(fp, x.float(), 3, ck, cv, kvs, dims=dims)   # f32 token
    with pytest.raises(ValueError):
        D.fused_decode_layers(fp, x, 3, ck[:, :10], cv[:, :10], kvs[..., :10], dims=dims)
    with pytest.raises(ValueError):
        D.fused_decode_layers({**fp, "wo": fp["wo"][..., :128]}, x, 3, ck, cv, kvs, dims=dims)


@pytest.mark.parametrize("v,k", [(24_000, 1536), (500, 256)])
def test_head4_kernel_matches_ref(dev, v, k):
    """K8 against its twin: the int32 sums are exact and the epilogue is the
    same f32 ops in the same order."""
    from mars5_tts_torch.ops.kernels import head4 as H

    g = torch.Generator(device=dev).manual_seed(v)
    wp, ws = H.pack_head4(torch.randn((v, k), generator=g, device=dev) * 0.03)
    x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
    n0 = H.launch_count
    got = H.head4_logits(x, wp, ws, n_vocab=v)
    torch.cuda.synchronize()
    assert H.launch_count == n0 + 1 and got.shape == (1, v)
    want = H.head4_logits_ref(x, wp, ws, n_vocab=v)
    peak = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * peak


def test_fused_engine_on_gpu(dev):
    """The quantized engine on the card (fused4 + the int4 head): one K2 and
    one K8 launch a decode step, tokens in the vocabulary window, and the
    first step's logits within the kernel bound of the CPU twins'."""
    import copy

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling
    from mars5_tts_torch.models.ar_decode_fused import (FusedCache, ar_generate_fused,
                                                        fused_step, prepare_fused)
    from mars5_tts_torch.ops.kernels import decode_layer as D, head4 as H

    cfg = CodecLMConfig(n_vocab=1283, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=2, hidden_dim=1024, sliding_window=3000, n_spk_layers=1,
                        spk_hidden_dim=256)
    cpu = CodecLM(cfg).init_(torch.Generator().manual_seed(3)).to(torch.bfloat16).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(3)
    spk = r.integers(0, 1024, (30, 8))
    prompt = np.concatenate([r.integers(0, 258, 10), spk[:20, 0] + 258])
    s = ArSampling(n_phones_gen=10_000, eos_idx=1282, valid_start=258, valid_end=1283,
                   max_len=len(prompt) + 40)
    u = r.random(s.max_len).astype(np.float32)
    fp, dims = prepare_fused(gpu, s.max_len, 4, head4=True)
    n0 = (D.launch_count, H.launch_count)
    tokens, n_gen = ar_generate_fused(gpu, fp, dims, prompt, spk, sampling=s, uniforms=u)
    steps = n_gen - (len(tokens) >= s.max_len)
    assert (D.launch_count - n0[0], H.launch_count - n0[1]) == (steps, steps)
    gen = tokens[len(prompt):]
    assert n_gen > 0 and ((gen >= 257) & (gen < 1283)).all()
    fpc, _ = prepare_fused(cpu, s.max_len, 4, head4=True)
    logits = [fused_step(f, dims, cfg, int(prompt[-1]), len(prompt), FusedCache(dims, d))
              for f, d in ((fp, dev), (fpc, "cpu"))]
    _fused_eq_f32(logits[0].cpu(), logits[1])


def _mega_decoder(dim, nhead, hidden, n_layers, dev, seed):
    """A W8A8 NAR decoder stack on the card, bf16, with LN affines and biases
    moved off 1 / 0."""
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.quant import quantize_nar

    cfg = ResidualTransformerConfig(n_text_vocab=64, dim=dim, nhead=nhead, enc_layers=1,
                                    dec_layers=n_layers, n_spk_layers=1, t_emb_dim=64,
                                    hidden_dim=hidden)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        nar = ResidualTransformer(cfg).init_(g)
        with torch.no_grad():
            for name, p in nar.tfm.decoder.named_parameters():
                if p.ndim == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
        return quantize_nar(nar.to(torch.bfloat16)).tfm.decoder


def _mega_inputs(d, l, lk, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((2, l, d), generator=g, device=dev).to(torch.bfloat16)
    mem = torch.randn((2, lk, d), generator=g, device=dev).to(torch.bfloat16)
    tm = torch.zeros((2, l), dtype=torch.bool, device=dev)
    tm[1, l - l // 6:] = True
    mm = torch.zeros((2, lk), dtype=torch.bool, device=dev)
    mm[0, lk - 4:] = True
    return x, mem, tm, mm


@pytest.mark.parametrize("dim,nhead,hidden,n_layers,l,lk", [
    (256, 4, 768, 2, 100, 19),           # the CPU tests' geometry
    (1024, 16, 3072, 1, 725, 66),         # released widths, one layer
    (1024, 16, 3072, 16, 725, 66),        # the whole stack at the smoke shape
])
def test_mega_kernel_matches_ref(dev, dim, nhead, hidden, n_layers, l, lk):
    """K9 against ``mega_decoder_stack_ref`` on the same pack and inputs:
    within 0.03 x max|twin| (tests/test_nar_mega.py), one layer also within
    the fused bound with most bf16 elements exactly equal."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    mp = M.build_mega_pack(_mega_decoder(dim, nhead, hidden, n_layers, dev, n_layers))
    x, mem, tm, mm = _mega_inputs(dim, l, lk, dev, l)
    n0 = M.launch_count
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    torch.cuda.synchronize()
    assert M.launch_count == n0 + 1 and got.shape == x.shape and got.dtype == torch.bfloat16
    want = M.mega_decoder_stack_ref(mp, x, mem, tm, mm)
    d = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert d.max().item() <= 0.03 * want.float().abs().max().item(), d.max().item()
    if n_layers == 1:
        _fused_eq(got, want)


def test_mega_kernel_rejects_what_it_does_not_take(dev):
    from mars5_tts_torch.ops.kernels import nar_mega as M

    dec = _mega_decoder(256, 4, 768, 1, dev, 0)
    mp = M.build_mega_pack(dec)
    x, mem, tm, mm = _mega_inputs(256, 40, 9, dev, 0)
    with pytest.raises(ValueError):
        M.mega_decoder_stack(mp, x.float(), mem)                     # f32 stream
    with pytest.raises(ValueError):
        M.mega_decoder_stack(mp, x, mem[..., :128])                  # memory width
    with pytest.raises(ValueError):
        M.mega_decoder_stack(mp, x, mem, tm[:, :10])                 # mask shape
    with pytest.raises(ValueError):
        M.mega_decoder_stack(M.MegaPack(mp.dims, mp.pack[:, :100], mp.svec, mp.bvec,
                                        mp.lnvec), x, mem)           # malformed pack
    with pytest.raises(ValueError):                                  # head dim 32
        M.build_mega_pack(_mega_decoder(256, 8, 768, 1, dev, 0))


@pytest.mark.parametrize("rows,length,t", [(2, 750, 0), (2, 70, 100), (1, 33, 199)])
def test_tail_kernel_equals_heads_kernel_and_ref(dev, rows, length, t):
    """K5 on the folded heads' bf16 logits picks exactly K6's indices from the
    same decoder output, and exactly its twin's."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    g = torch.Generator(device=dev).manual_seed(rows * 100 + length)
    d, n, kc = 1024, 7, 1025
    out = torch.randn((rows, length, d), generator=g, device=dev).to(torch.bfloat16)
    wf = torch.randn((n, kc, d), generator=g, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((n, kc), generator=g, device=dev)}
    u0 = torch.rand((1, length, n, kc), generator=g, device=dev)
    x_t = torch.randint(0, kc, (1, length, n), generator=g, device=dev)
    scal = D.tail_scalars(MultinomialDiffusion(kc, 200, device=dev), t)
    x8, xs = nar_heads_prequant(out)
    k6 = D.heads_diffusion_tail(x8, xs, folded, u0, x_t, scal, w=3.0, temp=0.7)
    logits = nar_heads_folded(folded, out)
    n0 = D.tail_launch_count
    got = D.diffusion_tail(logits, u0, x_t, scal, w=3.0, temp=0.7)
    torch.cuda.synchronize()
    assert D.tail_launch_count == n0 + 1
    assert torch.equal(got, k6)
    assert torch.equal(got, D.diffusion_tail_ref(logits, u0, x_t, scal, w=3.0, temp=0.7))


def test_tail_kernel_rejects_what_it_does_not_take(dev):
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    logits = torch.zeros((2, 8, 7, 1025), dtype=torch.bfloat16, device=dev)
    u0 = torch.rand((1, 8, 7, 1025), device=dev)
    x_t = torch.zeros((1, 8, 7), dtype=torch.long, device=dev)
    scal = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        D.diffusion_tail(logits.float(), u0, x_t, scal, w=3.0, temp=0.7)   # f32 logits
    with pytest.raises(ValueError):
        D.diffusion_tail(logits, u0[:, :4], x_t, scal, w=3.0, temp=0.7)    # u0 shape
    with pytest.raises(ValueError):
        D.diffusion_tail(logits[:, :, :, :1000], u0[..., :1000].contiguous(), x_t,
                         scal[:4], w=3.0, temp=0.7)                        # scalars shape
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 7, 2100), dtype=torch.bfloat16, device=dev)
        D.diffusion_tail(big, torch.rand((1, 8, 7, 2100), device=dev), x_t, scal, w=1.0,
                         temp=0.7)                                         # K > 2048


def test_mega_and_split_routes_on_gpu(dev):
    """A small W8A8 NAR (D 128, head dim 64) over a deep-clone sequence on the
    card, generator path: ``mega`` (the pack) runs K9 once a reverse step and none
    of K3/K4 in the decoder; ``tail="split"`` runs K5 once a step in place of
    K6 and gives K6's grid exactly."""
    import copy

    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels import diffusion_tail as D, nar_fused as F, nar_mega as M
    from mars5_tts_torch.ops.quant import quantize_nar

    cfg = ResidualTransformerConfig(n_text_vocab=64, dim=128, nhead=2, enc_layers=1,
                                    dec_layers=2, n_spk_layers=1, t_emb_dim=64,
                                    hidden_dim=256)
    cpu = quantize_nar(ResidualTransformer(cfg).init_(torch.Generator().manual_seed(0))
                       .to(torch.bfloat16).eval())
    gpu = copy.deepcopy(cpu).to(dev)
    T, lc, lx = 4, 300, 40
    r = np.random.default_rng(4)
    x = np.repeat(r.integers(0, 1024, lx)[None, :, None], 8, axis=2)
    batch = (r.integers(0, 64, (1, 9)), r.integers(0, 1024, (1, lc, 8)), np.asarray([9]),
             np.asarray([lc]), x, np.zeros((1, lx), bool))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=1)
    diff = MultinomialDiffusion(1025, T, device=dev)
    grids = {}
    routes = (("heads", {}), ("split", dict(tail="split")),
              ("mega", dict(mega=M.build_mega_pack(gpu.tfm.decoder))))
    for route, kw in routes:
        n0 = (M.launch_count, F.fused_linear_launches, D.launch_count, D.tail_launch_count)
        grids[route] = perform_simple_inference(
            gpu, batch, diff, T, dsh, generator=torch.Generator(device=dev).manual_seed(1), **kw)
        torch.cuda.synchronize()
        n1 = (M.launch_count, F.fused_linear_launches, D.launch_count, D.tail_launch_count)
        want = {"heads": (0, 2 * 2 * T, T, 0), "split": (0, 2 * 2 * T, 0, T),
                "mega": (T, 0, T, 0)}[route]
        assert tuple(b - a for a, b in zip(n0, n1)) == want, route
    assert torch.equal(grids["split"], grids["heads"])
    assert (grids["mega"] == grids["heads"]).float().mean().item() >= 0.5
    assert int(grids["mega"].min()) >= 0 and int(grids["mega"].max()) <= 1024
