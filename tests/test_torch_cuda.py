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
    (2, 1200, 1200, 8, torch.bfloat16, True),     # a tp = 2 rank's NAR heads
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


def test_mha_kernel_reads_a_tp_ranks_qkv_views(dev):
    """A tp = 2 rank's self-attention: q, k and v are views of its own
    (B, L, 3 x 8 x 64) in-projection output, read in place."""
    from mars5_tts_torch.ops.kernels import mha as K

    b, l, h, d = 2, 1200, 8, 64
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((b, l, 3 * h * d), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, l, h, d) for i in range(3))
    mask = torch.zeros((b, l), dtype=torch.bool, device=dev)
    mask[1, 1000:] = True
    n0 = K.launch_count
    out = K.mha(q, k, v, mask)
    torch.cuda.synchronize()
    assert K.launch_count == n0 + 1
    ref = K.mha_ref(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    assert bool(((out.float() - ref.float()).abs() <= K.bf16_row_bound(ref)).all())


def test_mha_kernel_rejects_other_head_dims(dev):
    from mars5_tts_torch.ops.kernels import mha as K

    q = torch.zeros((1, 8, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.mha(q, q, q)


def _strided_qkv(b, l, h, dev, seed):
    """q, k, v as the int8 decoder slices them: views of one (B, L, 3 H 64)
    projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, l, 3 * h * 64), generator=g, device=dev).to(torch.bfloat16)
    return [qkv[..., i * h * 64:(i + 1) * h * 64].reshape(b, l, h, 64) for i in range(3)]


def _assert_k1(K, out, ref):
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= K.bf16_row_bound(ref)).all()), err.max().item()


def test_mha_kernel_int8_decoder_call(dev):
    """The int8 decoder's last layer: 750 queries over 1,200 keys, all three
    strided views of a (2, 1200, 3072) projection, the second row's tail
    masked; read in place through the tensor maps."""
    from mars5_tts_torch.ops.kernels import mha as K

    q, k, v = _strided_qkv(2, 1200, 16, dev, 3)
    mask = torch.zeros((2, 1200), dtype=torch.bool, device=dev)
    mask[1, 1000:] = True
    out = K.mha(q[:, 450:], k, v, mask)
    torch.cuda.synchronize()
    _assert_k1(K, out, K.mha_ref(q[:, 450:].contiguous(), k.contiguous(), v.contiguous(), mask))


@pytest.mark.parametrize("b,lq,lk,h", [
    (2, 525, 525, 16),        # the smoke's NAR prompt, no full tile of 192 queries
    (2, 725, 725, 16),        # the smoke request's NAR frames
    (1, 1201, 1201, 4),       # one key past a 128-key tile
    (2, 750, 1201, 3),
    (1, 1344, 1344, 19),      # 7 x 19 = 133 CTAs: one past a wave of 132
    (7, 192, 200, 19),        # 133 CTAs of one query tile each
    (2, 193, 129, 1),         # one query past a tile: a CTA with one live row
    (1, 65, 1, 2),            # a single key
])
def test_mha_kernel_tile_edges(dev, b, lq, lk, h):
    """Lengths off the 192-query and 128-key tiles and grids that leave a
    partial last wave, against the twin; the last row's key tail masked."""
    from mars5_tts_torch.ops.kernels import mha as K

    q, k, v = _qkv((b, lq, h, 64), lk, torch.bfloat16, dev, seed=lq + 7 * lk)
    mask = torch.zeros((b, lk), dtype=torch.bool, device=dev)
    mask[-1, lk - lk // 3:] = True
    out = K.mha(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_k1(K, out, K.mha_ref(q, k, v, mask))
    _assert_k1(K, K.mha(q, k, v), K.mha_ref(q, k, v))


def test_mha_kernel_rejects_ineligible_views(dev):
    """A view the tensor maps cannot address raises before any launch."""
    from mars5_tts_torch.ops.kernels import mha as K

    qkv = torch.zeros((2, 40, 3 * 128 + 8), device=dev, dtype=torch.bfloat16)
    odd = qkv[..., 1:129].reshape(2, 40, 2, 64)          # base off a 16-byte boundary
    n0 = K.launch_count
    with pytest.raises(ValueError):
        K.mha(odd, odd, odd)
    step = qkv[..., :256:2].reshape(2, 40, 2, 64)        # head dim not unit-stride
    with pytest.raises(ValueError):
        K.mha(step, step, step)
    assert K.launch_count == n0


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


def _k3_kwargs(variant, k, n, lead, g, dev):
    """``variant``: plain, ln_bias or residual; ``_bf16`` for bf16 LN and bias
    vectors (the decoder's), else f32."""
    vec = torch.bfloat16 if variant.endswith("_bf16") else torch.float32
    if variant.startswith("ln_bias"):
        return dict(ln=((1 + 0.1 * torch.randn(k, generator=g, device=dev)).to(vec),
                        (0.1 * torch.randn(k, generator=g, device=dev)).to(vec)),
                    bias=(0.1 * torch.randn(n, generator=g, device=dev)).to(vec))
    if variant.startswith("residual"):
        return dict(bias=(0.1 * torch.randn(n, generator=g, device=dev)).to(vec),
                    residual=torch.randn((*lead, n), generator=g, device=dev).to(torch.bfloat16))
    return {}


@pytest.mark.parametrize("m,k,n,variant", [
    (300, 256, 192, "ln_bias"), (70, 1024, 3072, "ln_bias"), (2400, 1024, 1024, "residual"),
    (17, 128, 64, "plain"),
    # ragged rows (one, either side of a 64-row warpgroup, the last layer's
    # 1,500), ragged 128-wide column tiles (64, 192), K = 3072
    (1, 1024, 3072, "ln_bias"), (63, 1024, 192, "residual"), (65, 1024, 64, "ln_bias"),
    (1500, 1024, 1024, "ln_bias"), (2400, 1024, 3072, "ln_bias"), (129, 3072, 1024, "residual"),
    (200, 3072, 192, "plain"),
    # 256-row weight tiles (gemm_plan) with a ragged last one: 64 of its 256 columns
    (2400, 1024, 2880, "residual"),
    # the decoder's bf16 LN and bias vectors, read as they are
    (2400, 1024, 3072, "ln_bias_bf16"), (1500, 1024, 1024, "ln_bias_bf16"),
    (63, 1024, 192, "residual_bf16")])
def test_fused_linear_kernel_matches_ref(dev, m, k, n, variant):
    """K3 equals its twin bit for bit: an exact int32 product and the same
    rounded operations around it."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16)
    w = _qw(n, k, g, dev)
    kw = _k3_kwargs(variant, k, n, (1, m), g, dev)
    n0 = F.fused_linear_launches
    out = F.fused_linear(x, w, **kw)
    torch.cuda.synchronize()
    assert F.fused_linear_launches == n0 + 1 and out.shape == (1, m, n)
    assert torch.equal(out, F.fused_linear_ref(x, w, **kw))


@pytest.mark.parametrize("m,k,f,vec", [
    (200, 256, 384, torch.float32), (2400, 1024, 3072, torch.float32),
    (1, 1024, 3072, torch.float32), (63, 1024, 3072, torch.float32),
    (65, 256, 128, torch.float32), (1500, 1024, 3072, torch.float32),
    (130, 3072, 1024, torch.float32),
    # the decoder's bf16 LN and bias vectors
    (2400, 1024, 3072, torch.bfloat16), (1500, 1024, 3072, torch.bfloat16)])
def test_fused_ffn_kernel_matches_ref(dev, m, k, f, vec):
    """K4 within the JAX kernel tests' bound and at least 99.9% equal to its
    twin: only ``expf`` in the sigmoid may round differently."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m)
    lead = (2, m // 2) if m % 2 == 0 else (1, m)
    x = torch.randn((*lead, k), generator=g, device=dev).to(torch.bfloat16)
    ln = ((1 + 0.1 * torch.randn(k, generator=g, device=dev)).to(vec),
          (0.1 * torch.randn(k, generator=g, device=dev)).to(vec))
    args = (x, ln, _qw(f, k, g, dev), _qw(f, k, g, dev), _qw(k, f, g, dev),
            (0.1 * torch.randn(k, generator=g, device=dev)).to(vec))
    n0 = F.fused_ffn_launches
    out = F.fused_ffn(*args)
    torch.cuda.synchronize()
    assert F.fused_ffn_launches == n0 + 1 and out.shape == x.shape
    _fused_eq(out, F.fused_ffn_ref(*args), exact_frac=0.999)


def test_w8a8_kernels_refuse_strided_rows(dev):
    """The kernels read x and the residual as contiguous rows: a strided
    slice of the decoder's x, [:, 450:], raises and launches nothing."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn((2, 1200, 1024), generator=g, device=dev).to(torch.bfloat16)[:, 450:]
    ln = (torch.ones(1024, device=dev), torch.zeros(1024, device=dev))
    w = _qw(1024, 1024, g, dev)
    n3, n4 = F.fused_linear_launches, F.fused_ffn_launches
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_linear(x, w, ln=ln)
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_linear(x.contiguous(), w, residual=x)
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_ffn(x, ln, _qw(3072, 1024, g, dev), _qw(3072, 1024, g, dev),
                    _qw(1024, 3072, g, dev), torch.zeros(1024, device=dev))
    assert (F.fused_linear_launches, F.fused_ffn_launches) == (n3, n4)


def test_w8a8_kernels_reject_what_they_do_not_take(dev):
    from mars5_tts_torch.ops.kernels import nar_fused as F

    x = torch.zeros((1, 8, 256), device=dev, dtype=torch.bfloat16)
    n0 = F.fused_linear_launches
    with pytest.raises(ValueError):
        F.fused_linear(x, _qw(100, 256, None, dev))          # N not a multiple of 64
    with pytest.raises(ValueError):
        F.fused_linear(x.float(), _qw(64, 256, None, dev))   # f32 activations
    with pytest.raises(ValueError):
        F.fused_linear(x[..., :200], _qw(64, 200, None, dev))  # K not a multiple of 128
    with pytest.raises(ValueError):
        F.fused_linear(torch.zeros((1, 8, 3200), device=dev, dtype=torch.bfloat16),
                       _qw(64, 3200, None, dev))            # K above 3072
    with pytest.raises(ValueError):                        # rows off a 16-byte boundary
        F.fused_linear(torch.zeros((1, 8, 264), device=dev, dtype=torch.bfloat16)[..., 4:260],
                       _qw(64, 256, None, dev))
    q, s = _qw(64, 256, None, dev)
    with pytest.raises(ValueError):                        # a weight TMA cannot read
        F.fused_linear(x, (q.t().contiguous().t(), s))
    assert F.fused_linear_launches == n0


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

    from mars5_tts_torch.models import ar_decode as AD
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import (FusedCache, FusedEngine, fused_step,
                                                        prepare_fused)
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
    AD.reset_counts()
    tokens, n_gen = ar_generate(gpu, prompt, spk, sampling=s, uniforms=u,
                                engine=FusedEngine(fp, dims))
    # a step launched past an EOS that ends the call counts too
    steps = n_gen - (len(tokens) >= s.max_len) + AD.discarded_steps
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


@pytest.mark.parametrize("dim,nhead,hidden,l,lk,masked", [
    (256, 4, 768, 77, 9, True),            # B L = 154 rows: a ragged row tile
    (256, 4, 768, 100, 66, False),
    (1024, 16, 3072, 725, 66, True),       # the smoke request: 1,450 rows
    (1024, 16, 3072, 1200, 9, False),      # the bench's frames, ten key tiles
    (1024, 16, 3072, 300, 130, True),      # a ragged second key tile of memory
])
def test_mega_kernel_layer_cases(dev, dim, nhead, hidden, l, lk, masked):
    """One K9 layer against its twin within the fused bound: ragged rows and
    key tiles, Lk of 9, 66 and 130 (not multiples of the 128-key ring tile or
    of 16), masks on and off, D 256 / F 768 and the released 1024 / 3072;
    one C call of 1 + 15 kernels."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    mp = M.build_mega_pack(_mega_decoder(dim, nhead, hidden, 1, dev, l + lk))
    x, mem, tm, mm = _mega_inputs(dim, l, lk, dev, l * lk)
    if not masked:
        tm = mm = None
    n0, k0 = M.launch_count, M.kernel_launches()
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    torch.cuda.synchronize()
    assert M.launch_count == n0 + 1 and M.kernel_launches() - k0 == M.kernels_per_call(1)
    _fused_eq(got, M.mega_decoder_stack_ref(mp, x, mem, tm, mm))


def test_mega_kernel_rejects_what_it_does_not_take(dev, monkeypatch):
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
    bad = M.mega_plan(mp.dims, 80, 18)[:6] + ((96, 4),)              # a tile width of 96
    monkeypatch.setattr(M, "mega_plan", lambda *a: bad)
    with pytest.raises(RuntimeError, match="cudaError"):
        M.mega_decoder_stack(mp, x, mem, tm, mm)


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


def _ring_inputs(b, w, h, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    return r(b, h, 64), r(b, w, h, 64), r(b, w, h, 64), r(b, h, 64), r(b, h, 64)


@pytest.mark.parametrize("b,w,h,positions", [
    (1, 2001, 24, (600,)),                      # bf16 AR decode, released widths
    (4, 2001, 24, (600, 1200, 1900, 2400)),     # batched rows, the last wrapped
    (1, 2001, 12, (600,)),                      # a tp = 2 rank's heads
    (4, 2001, 12, (600, 1200, 1900, 2400)),
    (2, 64, 4, (5, 100)),
    (3, 7, 2, (0, 6, 7)),                       # first step, last unwrapped, wrapped
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("self_column", [True, False])
def test_decode_attention_kernel_matches_ref(dev, b, w, h, positions, dtype, self_column):
    """K7 against ``decode_attention_ref``: within one ulp of the dtype (the
    f64 sums round once in both; only an f64 sum landing on the other side of
    an f32 rounding boundary can part them), and poisoned invalid slots do
    not reach the output."""
    from mars5_tts_torch.ops.kernels import decode_attention as A

    q, ck, cv, kn, vn = _ring_inputs(b, w, h, dtype, dev, w + b)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    new = (kn, vn) if self_column else ()
    n0 = A.launch_count
    got = A.decode_attention(q, ck, cv, pos, *new)
    torch.cuda.synchronize()
    assert A.launch_count == n0 + 1 and got.shape == q.shape and got.dtype == dtype
    want = A.decode_attention_ref(q, ck, cv, pos, *new)
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).abs() <= A.one_ulp(got, want)).all()
    valid = A.ring_valid(pos, w, self_column)
    ck2, cv2 = ck.clone(), cv.clone()
    ck2[~valid] = 1e3
    cv2[~valid] = -1e3
    assert torch.equal(A.decode_attention(q, ck2, cv2, pos, *new), got)


def test_decode_attention_kernel_rejects_what_it_does_not_take(dev):
    from mars5_tts_torch.ops.kernels import decode_attention as A

    q, ck, cv, kn, vn = _ring_inputs(2, 16, 2, torch.bfloat16, dev, 0)
    pos = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        A.decode_attention(q[..., :32], ck[..., :32], cv[..., :32], pos)   # head dim 32
    with pytest.raises(ValueError):
        A.decode_attention(q, ck.transpose(1, 2).contiguous().transpose(1, 2), cv, pos)
    with pytest.raises(ValueError):
        A.decode_attention(q.half(), ck.half(), cv.half(), pos)
    with pytest.raises(ValueError):
        A.decode_attention(q, ck, cv, pos, kn)


@pytest.mark.parametrize("b,w,positions", [
    (1, 2001, (0,)), (1, 2001, (1,)), (1, 2001, (2000,)),     # positions 0, 1, W - 1
    (1, 2001, (2001,)), (1, 2001, (4005,)),                    # W, 2 W + 3 (wrapped)
    (2, 8192, (300, 9000)),                                    # the largest window
    (8, 2001, (0, 5, 255, 256, 700, 1999, 2001, 5000)),        # 8 rows at mixed positions
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("self_column", [True, False])
@pytest.mark.parametrize("host_positions", [True, False])
def test_decode_attention_kernel_cluster_edges(dev, b, w, positions, dtype, self_column,
                                               host_positions):
    """K7 at the ring's edge positions, the largest window and 8 rows, with
    the cluster sized from host positions (1 CTA at position 0, 8 from 1,793
    slots up at one row) or, for a device tensor of positions, from the whole
    window: within one ulp of the twin either way."""
    from mars5_tts_torch.ops.kernels import decode_attention as A

    q, ck, cv, kn, vn = _ring_inputs(b, w, 24, dtype, dev, w + sum(positions))
    new = (kn, vn) if self_column else ()
    pos = list(positions) if host_positions else torch.tensor(positions, dtype=torch.int32,
                                                             device=dev)
    cluster = A.launch_args(q, ck, cv, pos, *new)[-1]
    n = min(max(positions) + 1, w) if host_positions else w
    assert cluster == A.cluster_size(n, b * 24) and (b > 1 or cluster == min(8, -(-n // 256)))
    n0 = A.launch_count
    got = A.decode_attention(q, ck, cv, pos, *new)
    torch.cuda.synchronize()
    assert A.launch_count == n0 + 1
    want = A.decode_attention_ref(q, ck, cv, pos, *new)
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).abs() <= A.one_ulp(got, want)).all()


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("full", [False, True])
def test_fused_decode_kernel_batched_matches_ref(dev, wbits, full):
    """K2 with B rows, each at its own position on both sides of the ring's
    wrap, against ``fused_step_ref``; each row also equals its one-row step."""
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    if full:
        cfg, max_len, positions = CodecLMConfig.mars5(24_000), 2000, (600, 1200, 1900, 2400)
    else:
        cfg = CodecLMConfig(n_vocab=512, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            n_layers=3, hidden_dim=512, sliding_window=24)
        max_len, positions = 40, (5, 30, 17, 0, 23, 24, 40, 2)
    fp, dims = prepare_fused(_decode_model(cfg, dev, wbits), max_len, wbits)
    b = len(positions)
    g = torch.Generator(device=dev).manual_seed(wbits)
    shape = (dims.n_layers, b, dims.window, dims.dim)
    (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.randn(shape, generator=g, device=dev) * 0.1)
                          for _ in range(2))
    kvs = torch.stack([ks, vs], dim=2).contiguous()
    x = fp["embed"][torch.arange(b, device=dev) * 3 + 7].to(torch.bfloat16)
    n0 = D.launch_count
    got = D.fused_decode_layers(fp, x, positions, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
    torch.cuda.synchronize()
    assert D.launch_count == n0 + 1
    want = D.fused_step_ref(fp, x, positions, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        _fused_eq_f32(a, w)
    for i in (0, b - 1):
        one = D.fused_decode_layers(fp, x[i:i + 1], positions[i], ck[:, i].contiguous(),
                                    cv[:, i].contiguous(), kvs[:, i].contiguous(), dims=dims,
                                    norm_eps=cfg.norm_eps)
        assert torch.equal(one[0], got[0][i:i + 1])
        assert torch.equal(one[1], got[1][:, i:i + 1])


@pytest.mark.parametrize("b,v,k,dtype", [
    *[(b, 24_000, 1536, torch.bfloat16) for b in range(1, 9)],   # the head, 1..8 rows
    (4, 100_000, 1536, torch.bfloat16),   # 24 chunks a slab: the ring refills
    (3, 500, 256, torch.bfloat16),        # 4 rows a slab, the last one ragged
    (2, 24_000, 1536, torch.float32),     # an f32 model's rows
])
def test_head4_kernel_slabs_bitwise(dev, b, v, k, dtype):
    """K8 bitwise equal to its twin (exact int32 sums, the same f32 epilogue,
    the twin's quant) at 1..8 rows, over a vocabulary that is not a multiple
    of a slab, with one kernel launch a call."""
    from mars5_tts_torch.ops.kernels import head4 as H

    g = torch.Generator(device=dev).manual_seed(b * v + k)
    wp, ws = H.pack_head4(torch.randn((v, k), generator=g, device=dev) * 0.03)
    x = (torch.randn((b, k), generator=g, device=dev) * 3).to(dtype)
    n0, k0 = H.launch_count, H.kernel_launches()
    got = H.head4_logits(x, wp, ws, n_vocab=v - 7)
    torch.cuda.synchronize()
    assert (H.launch_count - n0, H.kernel_launches() - k0) == (1, 1)
    assert torch.equal(got, H.head4_logits_ref(x, wp, ws, n_vocab=v - 7))


@pytest.mark.parametrize("b", [3, 8])
def test_head4_kernel_batched_matches_ref(dev, b):
    from mars5_tts_torch.ops.kernels import head4 as H

    g = torch.Generator(device=dev).manual_seed(b)
    wp, ws = H.pack_head4(torch.randn((24_000, 1536), generator=g, device=dev) * 0.03)
    x = torch.randn((b, 1536), generator=g, device=dev).to(torch.bfloat16)
    got = H.head4_logits(x, wp, ws, n_vocab=24_000)
    torch.cuda.synchronize()
    assert got.shape == (b, 24_000)
    assert torch.equal(got, H.head4_logits_ref(x, wp, ws, n_vocab=24_000))
    assert torch.equal(got[1:2], H.head4_logits(x[1:2], wp, ws, n_vocab=24_000))
    with pytest.raises(ValueError):
        H.head4_logits(torch.zeros((9, 1536), dtype=torch.bfloat16, device=dev), wp, ws,
                       n_vocab=24_000)


def test_batched_ar_engines_on_gpu(dev):
    """The bf16 AR engine on the card runs K7 once a layer a step, for every
    row; its tokens equal the CPU run's for an f32 model. The quantized
    engine runs K2 (and K8) once a step for all rows."""
    import copy

    from mars5_tts_torch.models import ar_decode as AD
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate_batched
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.ops.kernels import decode_attention as A, decode_layer as D, head4 as H

    cfg = CodecLMConfig(n_vocab=1283, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=2, hidden_dim=1024, sliding_window=3000, n_spk_layers=1,
                        spk_hidden_dim=256)
    cpu = CodecLM(cfg).init_(torch.Generator().manual_seed(5)).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(5)
    spks = [r.integers(0, 1024, (n, 8)) for n in (30, 21, 25)]
    prompts = [np.concatenate([r.integers(0, 258, 6 + 3 * i), spks[i][:15, 0] + 258])
               for i in range(3)]
    s = ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283,
                   max_len=max(len(p) for p in prompts) + 30)
    u = r.random((s.max_len, 3)).astype(np.float32)
    est = [5, 30, 12]
    want = ar_generate_batched(cpu, prompts, spks, sampling=s, uniforms=u, est_lens=est)
    n0 = A.launch_count
    got = ar_generate_batched(gpu, prompts, spks, sampling=s, uniforms=u, est_lens=est)
    steps = max(n - (len(t) >= s.max_len) for t, n in got)
    assert A.launch_count - n0 == cfg.n_layers * steps
    for (tg, ng), (tw, nw) in zip(got, want):
        np.testing.assert_array_equal(tg, tw)
        assert ng == nw

    gpu16 = copy.deepcopy(cpu).to(torch.bfloat16).to(dev)
    fp, dims = prepare_fused(gpu16, s.max_len, 4, head4=True, batch=3)
    n0 = (D.launch_count, H.launch_count, A.launch_count)
    AD.reset_counts()
    outs = ar_generate_batched(gpu16, prompts, spks, sampling=s, uniforms=u, est_lens=est,
                               engine=FusedEngine(fp, dims))
    steps = max(n - (len(t) >= s.max_len) for t, n in outs) + AD.discarded_steps
    assert (D.launch_count - n0[0], H.launch_count - n0[1], A.launch_count - n0[2]) == (
        steps, steps, 0)
    for (t, n), p in zip(outs, prompts):
        gen = t[len(p):]
        assert len(gen) == n and ((gen >= 257) & (gen < 1283)).all()


@pytest.mark.parametrize("b", range(1, 9))
def test_fused_decode_persistent_step_rows(dev, b):
    """K2 as one cooperative launch a step at 1-8 rows (a 512-wide, 4-layer
    model, window 100, rows on both sides of the wrap): one kernel launch a
    call, within the twin's bound, each row bitwise its one-row step."""
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    cfg = CodecLMConfig(n_vocab=512, dim=512, n_heads=8, n_kv_heads=8, head_dim=64,
                        n_layers=4, hidden_dim=1024, sliding_window=100)
    fp, dims = prepare_fused(_decode_model(cfg, dev, b), 150, 4 if b % 2 else 8)
    positions = [int(p) for p in np.random.default_rng(b).integers(0, 150, b)]
    g = torch.Generator(device=dev).manual_seed(b)
    shape = (dims.n_layers, b, dims.window, dims.dim)
    (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.randn(shape, generator=g, device=dev) * 0.1)
                          for _ in range(2))
    kvs = torch.stack([ks, vs], dim=2).contiguous()
    x = fp["embed"][torch.arange(b, device=dev) * 5 + 3].to(torch.bfloat16)
    got = D.fused_decode_layers(fp, x, positions, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
    torch.cuda.synchronize()
    n0 = D.kernel_launches()
    D.fused_decode_layers(fp, x, positions, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
    torch.cuda.synchronize()
    assert D.kernel_launches() == n0 + 1
    want = D.fused_step_ref(fp, x, positions, ck, cv, kvs, dims=dims, norm_eps=cfg.norm_eps)
    for a, w in zip(got, want):
        _fused_eq_f32(a, w)
    for i in range(b):
        one = D.fused_decode_layers(fp, x[i:i + 1], positions[i], ck[:, i].contiguous(),
                                    cv[:, i].contiguous(), kvs[:, i].contiguous(), dims=dims,
                                    norm_eps=cfg.norm_eps)
        assert torch.equal(one[0], got[0][i:i + 1])
        assert torch.equal(one[1], got[1][:, i:i + 1])


def test_fused_decode_raises_when_the_grid_cannot_be_resident(dev, monkeypatch):
    """A plan of more blocks than the card can hold at once: the cooperative
    launch is refused, the wrapper raises, and nothing else runs; the next
    call on a plan that fits runs (the refusal leaves no error behind)."""
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    cfg = CodecLMConfig(n_vocab=300, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=1, hidden_dim=512, sliding_window=24)
    fp, dims = prepare_fused(_decode_model(cfg, dev, 0), 40, 8)
    ck, cv, kvs = _ring(dims, None, dev)
    x = fp["embed"][:1].to(torch.bfloat16)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = D.persistent_plan(dims, 1, sm, 40)             # 40 blocks an SM: never resident
    rows = torch.tensor(plan.rows, dtype=torch.int32, device=dev)
    barrier = torch.zeros(64, dtype=torch.int32, device=dev)
    monkeypatch.setattr(D, "_launch_plan", lambda *_: (plan, rows, barrier))
    n0, k0 = D.launch_count, D.kernel_launches()
    with pytest.raises(RuntimeError):
        D.fused_decode_layers(fp, x, 3, ck, cv, kvs, dims=dims)
    assert D.launch_count == n0 and D.kernel_launches() == k0
    monkeypatch.undo()
    D.fused_decode_layers(fp, x, 3, ck, cv, kvs, dims=dims)
    torch.cuda.synchronize()
    assert D.launch_count == n0 + 1 and D.kernel_launches() == k0 + 1


@pytest.mark.parametrize("rows,length", [(2, 1), (2, 31), (2, 33), (1, 64), (2, 750)])
def test_heads_tail_kernel_ragged_frames(dev, rows, length):
    """K6 at frame counts that leave a ragged last block of 32, with and
    without CFG: two kernel launches a call, indices equal to the twin's but
    at its near-ties, none in the padded classes; K5 equals it exactly."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    g = torch.Generator(device=dev).manual_seed(rows * 7 + length)
    d, n, kc = 1024, 7, 1025
    out = torch.randn((rows, length, d), generator=g, device=dev).to(torch.bfloat16)
    x8, xs = nar_heads_prequant(out)
    wf = torch.randn((n, kc, d), generator=g, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((n, kc), generator=g, device=dev)}
    u0 = torch.rand((1, length, n, kc), generator=g, device=dev)
    x_t = torch.randint(0, kc, (1, length, n), generator=g, device=dev)
    scal = D.tail_scalars(MultinomialDiffusion(kc, 200, device=dev), 50)
    args = (x8, xs, folded, u0, x_t, scal)
    got = D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
    torch.cuda.synchronize()
    n0 = D.kernel_launches()
    D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
    torch.cuda.synchronize()
    assert D.kernel_launches() == n0 + 2
    assert int(got.max()) < kc
    want = D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)
    top2 = torch.topk(D.tail_scores(*args, w=3.0, temp=0.7), 2, dim=-1).values
    assert not bool(((got != want) & ((top2[..., 0] - top2[..., 1]) > 1e-5)).any())
    k5 = D.diffusion_tail(nar_heads_folded(folded, out), u0, x_t, scal, w=3.0, temp=0.7)
    assert torch.equal(k5, got)


# ------------------------------------------------- K3/K4 grouped, K1 int8

def _qwg(n, k, gsize, g, dev):
    """A weight with per-K-group scales (G, N), or per-row ones at gsize 0."""
    from mars5_tts_torch.ops.quant import quantize_weight_grouped
    if not gsize:
        return _qw(n, k, g, dev)
    return quantize_weight_grouped(torch.randn((n, k), generator=g, device=dev) * 0.05, gsize)


@pytest.mark.parametrize("m,k,n,gsize,w_grouped,variant", [
    # the decoder's sites at gsize 128: qkv (G = 8), caq (per-row weights),
    # an out-projection with its residual
    (2400, 1024, 3072, 128, True, "ln_bias_bf16"), (2400, 1024, 1024, 128, False, "ln_bias_bf16"),
    (2400, 1024, 1024, 128, True, "residual_bf16"),
    # groups inside a stage (32, 64), across stages (256, 384), a group of
    # three k-steps (96), ragged rows and column tiles
    (300, 256, 192, 32, True, "ln_bias"), (63, 1024, 192, 64, False, "residual"),
    (1, 1024, 64, 256, True, "plain"), (129, 3072, 1024, 384, True, "residual"),
    (70, 3072, 128, 96, True, "plain"), (65, 3072, 192, 96, False, "ln_bias")])
def test_fused_linear_grouped_kernel_matches_ref(dev, m, k, n, gsize, w_grouped, variant):
    """Grouped K3 equals its twin bit for bit: exact int32 partials, each
    group's rescale and the sum in the twin's order, unfused."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m + n + gsize)
    x = torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16)
    w = _qwg(n, k, gsize if w_grouped else 0, g, dev)
    kw = _k3_kwargs(variant, k, n, (1, m), g, dev)
    n0, g0 = F.fused_linear_launches, F.fused_linear_grouped_launches
    out = F.fused_linear(x, w, groups=k // gsize, **kw)
    torch.cuda.synchronize()
    assert (F.fused_linear_launches, F.fused_linear_grouped_launches) == (n0 + 1, g0 + 1)
    assert torch.equal(out, F.fused_linear_ref(x, w, groups=k // gsize, **kw))


@pytest.mark.parametrize("m,k,n,gsize,w_grouped,variant,tile", [
    # 128-wide plans on 132 SMs (the caq site; 120 tiles of 128 in one
    # round), then 64-wide ones: ragged rows and columns, groups inside a
    # stage and across two and three stages (256, 384)
    (1200, 1024, 1536, 128, True, "ln_bias_bf16", 128),
    (2400, 1024, 1024, 128, False, "ln_bias_bf16", 128),
    (130, 1024, 192, 128, True, "residual", 64), (97, 512, 320, 32, True, "ln_bias", 64),
    (300, 3072, 320, 256, True, "residual_bf16", 64), (257, 3072, 192, 384, False, "plain", 64),
    (1200, 3072, 1536, 384, True, "ln_bias", 128)])
def test_fused_linear_grouped_kernel_tiles(dev, m, k, n, gsize, w_grouped, variant, tile):
    """Grouped K3 on the tile the plan takes (64 or 128 wide, asserted) equals
    its twin bit for bit."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    assert F.gemm_plan(m, n, k, 0, F._sms(dev), True)[0] == tile
    g = torch.Generator(device=dev).manual_seed(m + n + gsize + 7)
    x = torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16)
    w = _qwg(n, k, gsize if w_grouped else 0, g, dev)
    kw = _k3_kwargs(variant, k, n, (1, m), g, dev)
    out = F.fused_linear(x, w, groups=k // gsize, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, F.fused_linear_ref(x, w, groups=k // gsize, **kw))


@pytest.mark.parametrize("m,k,n,gsize,w_grouped,low", [
    (256, 1024, 1024, 128, True, -127), (130, 3072, 192, 256, True, -127),
    (130, 3072, 192, 256, False, -128), (200, 3072, 256, 384, True, -127),
    (200, 3072, 256, 384, False, -128), (1200, 1024, 1536, 128, True, -128)])
def test_fused_linear_grouped_kernel_at_the_largest_partials(dev, m, k, n, gsize, w_grouped,
                                                             low):
    """Activations and weights of one magnitude, +-127 after quantization
    (the weights' negative ones ``low``), with two rows of x and sixteen of
    W all of one sign: a group's int32 partial reaches +-gsize x 127^2, or
    +-gsize x 128 x 127 with -128 weights (6,242,304 at gsize 384), which
    the fold must convert and rescale exactly. Each output equals the
    twin's bit for bit."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m + gsize - low)
    sx = torch.randint(0, 2, (1, m, k), generator=g, device=dev) * 2 - 1
    sx[0, 0], sx[0, 1] = 1, -1
    x = (0.5 * sx).to(torch.bfloat16)
    sw = torch.randint(0, 2, (n, k), generator=g, device=dev) * 2 - 1
    sw[:8], sw[8:16] = -1, 1
    q = torch.where(sw > 0, 127, low).to(torch.int8)
    groups = k // gsize
    shape = (groups, n) if w_grouped else (n,)
    s = 1e-3 * (1 + torch.rand(shape, generator=g, device=dev))
    kw = _k3_kwargs("residual", k, n, (1, m), g, dev)
    out = F.fused_linear(x, (q, s), groups=groups, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, F.fused_linear_ref(x, (q, s), groups=groups, **kw))
    part = (127 * sx[0, :, :gsize]).double() @ q[:, :gsize].double().t()
    top = gsize * 127 * -low
    assert part.max().item() == top and part.min().item() == -top


@pytest.mark.parametrize("m,k,f,gsize,gsize2,vec", [
    (2400, 1024, 3072, 128, 128, torch.bfloat16),      # the decoder's: G = 8 and 24
    (200, 256, 384, 32, 64, torch.float32), (63, 1024, 3072, 128, 0, torch.float32),
    (1, 1024, 3072, 0, 384, torch.float32), (130, 3072, 1024, 96, 256, torch.bfloat16),
    # the smoke request's 725 frames (128-wide tiles); 64-wide ones on a
    # ragged M for both GEMMs
    (1450, 1024, 3072, 128, 128, torch.bfloat16), (97, 512, 1536, 256, 384, torch.float32)])
def test_fused_ffn_grouped_kernel_matches_ref(dev, m, k, f, gsize, gsize2, vec):
    """Grouped K4 within the fused bound and at least 99.9% equal to its twin,
    as K4 at one group: the GEMMs are exact, only ``expf`` in the sigmoid
    may round differently."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(m + gsize)
    lead = (2, m // 2) if m % 2 == 0 else (1, m)
    x = torch.randn((*lead, k), generator=g, device=dev).to(torch.bfloat16)
    ln = ((1 + 0.1 * torch.randn(k, generator=g, device=dev)).to(vec),
          (0.1 * torch.randn(k, generator=g, device=dev)).to(vec))
    args = (x, ln, _qwg(f, k, gsize, g, dev), _qwg(f, k, gsize, g, dev),
            _qwg(k, f, gsize2, g, dev), (0.1 * torch.randn(k, generator=g, device=dev)).to(vec))
    groups = dict(groups=k // gsize if gsize else 1, groups2=f // gsize2 if gsize2 else 1)
    n0, g0 = F.fused_ffn_launches, F.fused_ffn_grouped_launches
    out = F.fused_ffn(*args, **groups)
    torch.cuda.synchronize()
    assert (F.fused_ffn_launches, F.fused_ffn_grouped_launches) == (n0 + 1, g0 + 1)
    _fused_eq(out, F.fused_ffn_ref(*args, **groups), exact_frac=0.999)


def test_w8a8_grouped_kernels_refuse(dev):
    """A group size that is not a multiple of 32, or does not divide K, and
    scales of the wrong shape raise before any launch."""
    from mars5_tts_torch.ops.kernels import nar_fused as F

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 64, 1024), generator=g, device=dev).to(torch.bfloat16)
    w = _qwg(128, 1024, 128, g, dev)
    n0 = F.fused_linear_launches
    with pytest.raises(ValueError, match="multiple of 32"):
        F.fused_linear(x, _qwg(128, 1024, 64, g, dev), groups=64)      # 16-column groups
    with pytest.raises(ValueError, match="divide"):
        F.fused_linear(x, w, groups=3)
    with pytest.raises(ValueError, match="scales"):
        F.fused_linear(x, w, groups=4)                                  # sg (8, N) for 4 groups
    with pytest.raises(ValueError, match="scales"):
        F.fused_linear(x, w)                                            # sg at one group
    assert F.fused_linear_launches == n0


@pytest.mark.parametrize("b,lq,lk,h,masked", [
    (2, 1200, 1200, 16, True), (2, 1200, 1200, 16, False),   # NAR self-attention
    (2, 725, 66, 16, True),                                  # cross-attention, the smoke's
    (1, 130, 70, 2, True), (2, 77, 13, 3, False), (1, 65, 33, 1, True), (1, 1, 1, 1, False),
    # a ragged last CTA and tile, 66-key cross, a fully masked tail tile,
    # a row that keeps one key (as tests/test_torch_mha_int8.py)
    (2, 200, 200, 2, True), (2, 150, 66, 2, True), (2, 100, 300, 2, "tail"),
    (2, 70, 130, 2, "one"), (1, 192, 256, 3, False)])
def test_mha_int8_kernel_matches_ref(dev, b, lq, lk, h, masked):
    """The int8 mode within ``int8_bound`` of its twin (two one-step p8 flips
    and a bf16 ulp), one launch count a call and three kernels, on strided
    views of a qkv projection as the unfused decoder slices them."""
    from mars5_tts_torch.ops.kernels import mha as K

    g = torch.Generator(device=dev).manual_seed(lq + lk)
    d = h * 64
    qp = (2 * torch.randn((b, lq, 3 * d), generator=g, device=dev)).to(torch.bfloat16)
    kv = torch.randn((b, lk, 2 * d), generator=g, device=dev).to(torch.bfloat16)
    q = qp[..., :d].reshape(b, lq, h, 64)
    k, v = (kv[..., i * d:(i + 1) * d].reshape(b, lk, h, 64) for i in range(2))
    mask = None
    if masked:
        mask = torch.zeros((b, lk), dtype=torch.bool, device=dev)
    if masked is True:
        mask[-1, lk - lk // 5:] = True
        mask[0, min(3, lk - 1)] = lk > 1
    elif masked == "tail":
        mask[1, 140:] = True
    elif masked == "one":
        mask[0] = True
        mask[0, lk // 2] = False
    n0, i0, k0 = K.launch_count, K.int8_launch_count, K.kernel_launches()
    out = K.mha(q, k, v, mask, quantized=True)
    torch.cuda.synchronize()
    assert (K.launch_count, K.int8_launch_count) == (n0 + 1, i0 + 1)
    assert K.kernel_launches() - k0 == 3
    ref, tol = K.int8_bound(q, k, v, mask)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol).all()), (err - tol).max().item()


def test_mha_int8_kernel_refuses(dev):
    from mars5_tts_torch.ops.kernels import mha as K

    q = torch.zeros((1, 8, 2, 64), device=dev)
    n0 = K.launch_count
    with pytest.raises(ValueError, match="bf16"):
        K.mha(q, q, q, quantized=True)
    with pytest.raises(ValueError, match="head_dim"):
        K.mha(q[..., :32].bfloat16(), q[..., :32].bfloat16(), q[..., :32].bfloat16(),
              quantized=True)
    assert K.launch_count == n0


# ---------------------------------------------------------------- serving shapes

def _heads_tail_inputs(bs, rows, length, dev, seed):
    from mars5_tts_torch.models.nar import nar_heads_prequant

    g = torch.Generator(device=dev).manual_seed(seed)
    d, n, kc = 1024, 7, 1025
    out = torch.randn((rows, length, d), generator=g, device=dev).to(torch.bfloat16)
    wf = torch.randn((n, kc, d), generator=g, device=dev) * 0.03
    s = wf.abs().amax(-1) / 127.0
    folded = {"q": torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8), "s": s,
              "b": 0.1 * torch.randn((n, kc), generator=g, device=dev)}
    u0 = torch.rand((bs, length, n, kc), generator=g, device=dev)
    x_t = torch.randint(0, kc, (bs, length, n), generator=g, device=dev)
    return out, nar_heads_prequant(out), folded, u0, x_t


@pytest.mark.parametrize("bs,rows,t,greedy", [
    (1, 1, 150, False), (1, 1, 199, False),    # cond-only steps of the guidance interval
    (1, 2, 0, True),                           # CFG, the greedy last step (scalars[5] = 0)
    (1, 1, 0, True),
    (3, 3, 150, False), (3, 6, 50, False),     # a NAR wave of three rows
])
def test_heads_tail_kernels_at_serving_shapes(dev, bs, rows, t, greedy):
    """K6 at 750 frames with rows == bs (w taken as 1) and rows == 2 bs, the
    greedy scalars, one to three batch rows: indices equal to the twin's but
    within 1e-5 near-ties; K5 on the folded heads' logits equal to K6 and to
    its twin."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    out, (x8, xs), folded, u0, x_t = _heads_tail_inputs(bs, rows, 750, dev, rows * 10 + t)
    scal = D.tail_scalars(MultinomialDiffusion(1025, 200, device=dev), t, use_gumbel=not greedy)
    args = (x8, xs, folded, u0, x_t, scal)
    got = D.heads_diffusion_tail(*args, w=3.0, temp=0.7)
    want = D.heads_diffusion_tail_ref(*args, w=3.0, temp=0.7)
    top2 = torch.topk(D.tail_scores(*args, w=3.0, temp=0.7), 2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 1e-5
    assert got.shape == (bs, 750, 7)
    assert not bool(((got != want) & ~near_tie).any())
    logits = nar_heads_folded(folded, out)
    got5 = D.diffusion_tail(logits, u0, x_t, scal, w=3.0, temp=0.7)
    assert torch.equal(got5, got)
    assert torch.equal(got5, D.diffusion_tail_ref(logits, u0, x_t, scal, w=3.0, temp=0.7))


@pytest.mark.parametrize("l", [725, 1200])
def test_mega_kernel_one_row(dev, l):
    """K9 at B = 1 (a cond-only step, ``mega_plan(dims, L, Lk)`` at M = L):
    each layer of the released widths within the fused bound of its twin,
    and the 16-layer stack within 0.03 x max|twin|."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    dec = _mega_decoder(1024, 16, 3072, 16, dev, 16)
    mp = M.build_mega_pack(dec)
    x, mem, tm, mm = (a[1:] for a in _mega_inputs(1024, l, 66, dev, l))
    got = M.mega_decoder_stack(mp, x, mem, tm, mm)
    want = M.mega_decoder_stack_ref(mp, x, mem, tm, mm)
    assert got.shape == (1, l, 1024) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 0.03 * want.float().abs().max().item()
    one = M.build_mega_pack(_mega_decoder(1024, 16, 3072, 1, dev, 1))
    _fused_eq(M.mega_decoder_stack(one, x, mem, tm, mm), M.mega_decoder_stack_ref(one, x, mem, tm, mm))


def test_fused_final_logits_do_not_depend_on_the_batch(dev):
    """The quantized engine's final RMSNorm and int8 head at the released AR
    widths (1536 -> 24,000): each row of a call of 2 to 8 rows bitwise the
    row's own one-row call."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import final_logits, prepare_fused

    cfg = CodecLMConfig.mars5(24_000)
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.device(dev):
        model = CodecLM(cfg).init_(g).to(torch.bfloat16)
    fp, _ = prepare_fused(model, 64, 8)
    h = torch.randn((8, cfg.dim), generator=g, device=dev) * 3
    one = [final_logits(fp, h[i:i + 1], cfg) for i in range(8)]
    for b in range(2, 9):
        rows = final_logits(fp, h[:b], cfg)
        for i in range(b):
            assert torch.equal(one[i], rows[i:i + 1]), (b, i)


def test_fused_pool_rows_equal_solo_runs_on_gpu(dev):
    """A three-row ``ContinuousBatcher`` on the quantized engine (W4, K2 one
    call a step) over five requests in two buckets: each request's tokens
    equal its solo ``ar_generate`` run on the pool's engine and stream."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    cfg = CodecLMConfig(n_vocab=1283, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=2, hidden_dim=1024, sliding_window=3000, n_spk_layers=1,
                        spk_hidden_dim=256)
    with torch.device(dev):
        model = CodecLM(cfg).init_(torch.Generator(device=dev).manual_seed(5)).to(torch.bfloat16)
    r = np.random.default_rng(7)
    s = ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283, max_len=90)
    reqs = [Request(prompt=r.integers(0, 1283, n), spk_codes=r.integers(0, 1024, (20, 8)),
                    uniforms=r.random(90).astype(np.float32)) for n in (10, 50, 20, 45, 30)]
    engine = FusedEngine(*prepare_fused(model, s.max_len, 4, batch=3))
    pool = ContinuousBatcher(model, s, engine=engine, batch_size=3, chunk_steps=8,
                             prompt_buckets=(32, 64), spk_bucket=32)
    for q in reqs:
        pool.submit(q)
    n0 = D.launch_count
    pool.run()
    assert D.launch_count - n0 == pool.steps_run
    for q in reqs:
        ref, n = ar_generate(model, q.prompt, q.spk_codes, sampling=s, uniforms=q.uniforms,
                             engine=engine)
        np.testing.assert_array_equal(q.tokens, ref)
        assert q.n_gen == n


@pytest.mark.parametrize("width", ["narrow", "released"])
def test_pool_rows_equal_solo_runs_on_gpu(dev, width):
    """A three-row bf16 ``ContinuousBatcher`` (K7 once a layer a step, every
    GEMM and norm at the pool's three rows) over five requests in two
    buckets: each request's tokens equal its solo ``ar_generate`` run on the
    same stream. ``released``: the released AR widths (1536, 24 heads,
    24,000 ids) at two layers."""
    import dataclasses

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    cfg = (CodecLMConfig(n_vocab=1283, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                         n_layers=2, hidden_dim=1024, sliding_window=3000, n_spk_layers=1,
                         spk_hidden_dim=256) if width == "narrow"
           else dataclasses.replace(CodecLMConfig.mars5(24_000), n_layers=2))
    with torch.device(dev):
        model = CodecLM(cfg).init_(torch.Generator(device=dev).manual_seed(5)).to(torch.bfloat16)
    r = np.random.default_rng(7)
    s = ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283, max_len=90)
    reqs = [Request(prompt=r.integers(0, 1283, n), spk_codes=r.integers(0, 1024, (20, 8)),
                    uniforms=r.random(90).astype(np.float32)) for n in (10, 50, 20, 45, 30)]
    pool = ContinuousBatcher(model, s, batch_size=3, chunk_steps=8, prompt_buckets=(32, 64),
                             spk_bucket=32)
    for q in reqs:
        pool.submit(q)
    pool.run()
    assert pool.chunks_run > 1
    for i, q in enumerate(reqs):
        ref, n = ar_generate(model, q.prompt, q.spk_codes, sampling=s, uniforms=q.uniforms)
        np.testing.assert_array_equal(q.tokens, ref, err_msg=f"request {i}")
        assert q.n_gen == n


def test_mha_kernel_refuses_autograd(dev):
    """K1 has no backward: a CUDA attention past the 512-query threshold with
    autograd recording raises, in ``mha`` and through a NAR forward at 600
    frames; under ``no_grad`` (inference) the kernel launches as before."""
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels import mha as K

    q, k, v = _qkv((1, 600, 4, 64), 600, torch.float32, dev, seed=3)
    q.requires_grad_(True)
    n0 = K.launch_count
    with pytest.raises(RuntimeError, match="no backward"):
        K.mha(q, k, v)
    assert K.launch_count == n0
    with torch.no_grad():
        K.mha(q, k, v)
    assert K.launch_count == n0 + 1
    with torch.device(dev):
        nar = ResidualTransformer(ResidualTransformerConfig.tiny()).init_(
            torch.Generator(device=dev).manual_seed(0))
    args = [torch.zeros(s, dtype=torch.long, device=dev) for s in ((1, 5), (1, 6, 8))]
    args += [torch.full((1,), 5, device=dev), torch.full((1,), 6, device=dev),
             torch.zeros((1, 600, 8), dtype=torch.long, device=dev),
             torch.zeros((1, 600), dtype=torch.bool, device=dev),
             torch.zeros((1,), dtype=torch.long, device=dev)]
    with pytest.raises(RuntimeError, match="no backward"):
        nar(*args)


def _tiny_grads(ar, nar, diff, ab, nb, draws, dev, mesh=None):
    """{"ar"|"nar": {name: gradient}} of the AR and NAR losses at the
    modules' present parameters (the step's own gradients, before its
    optimizer runs), as global host tensors."""
    from mars5_tts_torch import train as T

    out = {}
    with T._spmd(mesh):
        for tag, model, loss in (
                ("ar", ar, lambda: T.ar_loss_fn(ar, *T.to_batch(ab, T.AR_DTYPES, dev, mesh))),
                ("nar", nar, lambda: T.nar_loss_fn(nar, diff, T.to_batch(nb, T.NAR_DTYPES, dev,
                                                                         mesh), draws))):
            params = T.trainable_params(model)
            grads = torch.autograd.grad(loss(), list(params.values()))
            out[tag] = {n: T._full(g).detach().cpu() for n, g in zip(params, grads)}
    return out


def _tiny_params(ar, nar):
    from mars5_tts_torch import train as T

    return {tag: {n: T._full(p.detach()).cpu() for n, p in m.named_parameters()}
            for tag, m in (("ar", ar), ("nar", nar))}


def test_train_step_on_gpu_matches_cpu(dev):
    """One ``train.make_train_step`` step of a tiny AR and NAR on the card and
    on the CPU, same weights, batch and draws: the step's gradients within
    atol 1e-5 + rtol 1e-4, the losses within rtol 1e-4, and the parameters
    after the step within 1e-5 beyond the difference of the two Adam
    updates that each side's gradients give (``assert_adam_step_close``)."""
    from torch_port_fixtures import assert_adam_step_close

    from mars5_tts_torch import data, train as T
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig

    corpus = data.synthetic_corpus(4, text_vocab=16)
    ab, nb = next(data.batches(corpus, 2, n_text_vocab_offset=16, eos_idx=63))
    out = {}
    lr, wd = 1e-3, 0.01
    for where in (torch.device("cpu"), dev):
        g = torch.Generator().manual_seed(0)
        ar = CodecLM(CodecLMConfig.tiny(64)).init_(g).to(where)
        nar = ResidualTransformer(ResidualTransformerConfig.tiny(16)).init_(g).to(where)
        diff = MultinomialDiffusion(1025, timesteps=8, device=where)
        draws = T.nar_draws(MultinomialDiffusion(1025, timesteps=8), nb[4].shape,
                            torch.Generator().manual_seed(1))
        draws = T.NarDraws(*(x.to(where) for x in (draws.t, draws.u, draws.drop)))
        grads = _tiny_grads(ar, nar, diff, ab, nb, draws, where)
        opt = T.make_optimizer(lr, weight_decay=wd, clip_norm=1.0)
        state, m = T.make_train_step(diff, opt)(T.init_train_state(ar, nar, opt), ab, nb, draws)
        out[where.type] = (m, grads, _tiny_params(ar, nar))
    (m_cpu, g_cpu, p_cpu), (m_gpu, g_gpu, p_gpu) = out["cpu"], out["cuda"]
    for tag in ("ar", "nar"):
        for n, gr in g_cpu[tag].items():
            np.testing.assert_allclose(g_gpu[tag][n].numpy(), gr.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{tag}.{n}")
        np.testing.assert_allclose(float(m_gpu[f"{tag}_loss"]), float(m_cpu[f"{tag}_loss"]),
                                   rtol=1e-4)
        assert_adam_step_close(p_gpu[tag], p_cpu[tag], g_gpu[tag], g_cpu[tag], lr, 1e-5, 1.0)


def test_sharded_train_step_on_one_gpu(dev):
    """``shard_train_state`` on a one-process NCCL mesh (dp 1 x tp 1): the
    DTensor step on the card gives the plain step's gradients (atol 1e-6 +
    rtol 1e-5), losses (within 1e-6) and parameters (within 1e-6 beyond the
    difference of the two Adam updates, ``assert_adam_step_close``)."""
    import socket

    import torch.distributed as dist
    from torch_port_fixtures import assert_adam_step_close

    from mars5_tts_torch import data, train as T
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.parallel import codeclm_specs, make_mesh, nar_specs

    corpus = data.synthetic_corpus(4, text_vocab=16)
    ab, nb = next(data.batches(corpus, 2, n_text_vocab_offset=16, eos_idx=63))
    diff = MultinomialDiffusion(1025, timesteps=8, device=dev)
    lr, wd = 1e-3, 0.01
    opt = T.make_optimizer(lr, weight_decay=wd, clip_norm=1.0)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=dev if dev.index is not None else torch.device("cuda", 0))
    try:
        out = []
        for sharded in (False, True):
            g = torch.Generator().manual_seed(0)
            ar = CodecLM(CodecLMConfig.tiny(64)).init_(g).to(dev)
            nar = ResidualTransformer(ResidualTransformerConfig.tiny(16)).init_(g).to(dev)
            state = T.init_train_state(ar, nar, opt, seed=3)
            mesh = None
            if sharded:
                mesh = make_mesh(dp=1, tp=1)
                state = T.shard_train_state(mesh, state, codeclm_specs(ar, 1), nar_specs(nar, 1))
            draws = T.nar_draws(diff, nb[4].shape, torch.Generator(device=dev).manual_seed(1))
            step_draws = draws
            if mesh is not None:
                step_draws = T.NarDraws(*(T._on_dp(mesh, x)
                                          for x in (draws.t, draws.u, draws.drop)))
            grads = _tiny_grads(state.ar, state.nar, diff, ab, nb, step_draws, dev, mesh)
            state, m = T.make_train_step(diff, opt)(state, ab, nb, draws)
            out.append(({k: float(v) for k, v in m.items()}, grads,
                        _tiny_params(state.ar, state.nar)))
    finally:
        dist.destroy_process_group()
    (m0, g0, p0), (m1, g1, p1) = out
    for tag in ("ar", "nar"):
        for n, gr in g0[tag].items():
            np.testing.assert_allclose(g1[tag][n].numpy(), gr.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"{tag}.{n}")
        assert abs(m0[f"{tag}_loss"] - m1[f"{tag}_loss"]) <= 1e-6 * abs(m0[f"{tag}_loss"])
        assert_adam_step_close(p1[tag], p0[tag], g1[tag], g0[tag], lr, 1e-6, 1.0)


def _entry_files(d):
    """Checkpoints of a full-width AR and NAR at two layers each (the port's
    ``save_checkpoint``: safetensors where it imports, else .pt), official
    Encodec and Vocos state dicts at the released configs
    (``tests/torch_replicas``) and a 7 s reference WAV."""
    import dataclasses
    import importlib.util

    from torch_replicas import make_encodec_state_dict, make_vocos_state_dict

    from mars5_tts_torch.audio.io import write_wav
    from mars5_tts_torch.hub import save_checkpoint
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.convert import unpermute_rope_rows
    from mars5_tts_torch.models.encodec import EncodecConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import VocosConfig
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})
    vocab = {}
    for key, tok in (("texttok.model", texttok), ("speechtok.model", speechtok)):
        tok.save(str(d / key[:-6]))
        vocab[key] = (d / key).read_text()
    fmt = "safetensors" if importlib.util.find_spec("safetensors") else "pt"
    g = torch.Generator().manual_seed(0)
    ar_cfg = dataclasses.replace(CodecLMConfig.mars5(1283), n_layers=2, n_spk_layers=2)
    nar_cfg = dataclasses.replace(ResidualTransformerConfig.mars5(259), enc_layers=2,
                                  dec_layers=2, n_spk_layers=2)
    paths = {"ar": d / f"ar.{fmt}", "nar": d / f"nar.{fmt}", "encodec": d / "encodec.pt",
             "vocos": d / "vocos.pt", "ref": d / "ref.wav"}
    for name, model, cfg in (("ar", CodecLM(ar_cfg), ar_cfg),
                             ("nar", ResidualTransformer(nar_cfg), nar_cfg)):
        sd = {k: v.numpy() for k, v in model.init_(g).state_dict().items()}
        for k in [k for k in sd if k.endswith(("attention.wq.weight", "attention.wk.weight"))]:
            sd[k] = unpermute_rope_rows(sd[k], cfg.head_dim)
        save_checkpoint(paths[name], sd, vocab, config=dataclasses.asdict(cfg))
    torch.save(make_encodec_state_dict(EncodecConfig(), seed=1)[2], paths["encodec"])
    torch.save(make_vocos_state_dict(VocosConfig(), seed=2)[2], paths["vocos"])
    ref = np.random.default_rng(3).standard_normal(7 * 24000) * 0.1
    write_wav(paths["ref"], ref.astype(np.float32))
    return paths


def test_cli_on_gpu_matches_cpu(dev, tmp_path, monkeypatch):
    """``cli.main`` at the released widths with two layers a stack, once on
    the card (default device) and once with ``--device cpu``, the same files
    and seed, a 7 s reference (525 frames: K1 on the card) and 8 reverse
    steps. A CUDA generator and a CPU generator of one seed draw different
    numbers, so the test (only) hands both runs the same draws: the AR's
    uniforms and the NAR's uniforms and initial noise, made with numpy from
    the seed and the request's shapes. Then the Encodec codes, the AR tokens
    and the NAR grid are identical, and the WAVs' PCM16 within 8 LSB of each
    other (the vocoder's f32 sums on the two devices); on the card K7 runs
    twice a decode step and K1 once a decoder layer a reverse step."""
    import wave

    import mars5_tts_torch.pipeline as pipeline
    from mars5_tts_torch import cli
    from mars5_tts_torch.diffusion.schedule import build_step_plan
    from mars5_tts_torch.ops.kernels import decode_attention as A, mha as K

    steps = 8
    paths = _entry_files(tmp_path)
    seqs, grids, codes = [], [], []
    ar_generate, nar, encode = (pipeline.ar_generate, pipeline.perform_simple_inference,
                                pipeline.Mars5TTS.encode_reference)

    def shared_ar(*a, sampling, seed, **k):
        u = np.random.default_rng(seed).random(sampling.max_len).astype(np.float32)
        seqs.append(ar_generate(*a, sampling=sampling, uniforms=u, **k))
        return seqs[-1]

    def shared_nar(model, batch, *a, generator=None, **k):
        x = batch[4]
        n = (len(build_step_plan(steps)[0]), 2, x.shape[0], batch[1].shape[1] + x.shape[1], 8,
             1025)
        r = np.random.default_rng(11)
        grids.append(nar(model, batch, *a, uniforms=r.random(n, dtype=np.float32),
                         x_init=r.integers(0, 1025, x.shape), **k).cpu())
        return grids[-1]

    def shared_encode(self, ref):
        codes.append(encode(self, ref).cpu())
        return codes[-1].to(self.device)

    monkeypatch.setattr(pipeline, "ar_generate", shared_ar)
    monkeypatch.setattr(pipeline, "perform_simple_inference", shared_nar)
    monkeypatch.setattr(pipeline.Mars5TTS, "encode_reference", shared_encode)
    pcm = {}
    for where in ("cuda", "cpu"):
        out = tmp_path / f"{where}.wav"
        argv = ["--text", "The quick brown fox jumps over the lazy dog.", "--ref",
                str(paths["ref"]), "--transcript", "A reference voice.", "--ar",
                str(paths["ar"]), "--nar", str(paths["nar"]), "--encodec", str(paths["encodec"]),
                "--vocos", str(paths["vocos"]), "--out", str(out), "--timesteps", str(steps),
                "--max-len", "700", "--trim-db", "200", "--seed", "5"]
        if where == "cpu":
            argv += ["--device", "cpu"]
        k1, k7 = K.launch_count, A.launch_count
        assert cli.main(argv) == 0
        if where == "cuda":
            n_gen = seqs[-1][1]
            # a decode step follows every token but the last (an EOS, or the cap)
            assert A.launch_count - k7 in (2 * (n_gen - 1), 2 * n_gen)
            assert K.launch_count - k1 >= 2 * steps
        with wave.open(str(out), "rb") as w:
            pcm[where] = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.int32)
    assert torch.equal(codes[0], codes[1])
    (gpu_seq, gpu_n), (cpu_seq, cpu_n) = seqs
    diff = np.flatnonzero(gpu_seq != cpu_seq) if gpu_seq.shape == cpu_seq.shape else [-1]
    assert len(diff) == 0, f"tokens part at {diff[0]} of {len(cpu_seq)} (prompt and generated)"
    assert gpu_n == cpu_n > 0
    assert torch.equal(grids[0], grids[1]), int((grids[0] != grids[1]).sum())
    assert pcm["cuda"].shape == pcm["cpu"].shape and len(pcm["cpu"]) > 0
    assert np.abs(pcm["cuda"] - pcm["cpu"]).max() <= 8


def test_tp_ranks_agree_on_the_card(dev):
    """Two tensor-parallel ranks of one gloo group sharing the card
    (``tools/tp_card.py``, chip_smoke's phase 6 (e) at two layers of the
    released widths): the same tokens, grid and teacher-forced logits on
    both, the logits and the grid within the stated budgets of one
    process's, K7 and K1 launched on each rank's heads and held against
    their twins there: K7 over the (1, 145)-slot ring of the 144-token
    request, K1 on strided qkv views in the NAR decoder (525 + 200 frames)
    and the speaker encoder (the identity + 525), two CFG rows each."""
    from mars5_tts_torch.tools import tp_card

    spec, outs = tp_card.run(2, ar={"n_layers": 2}, nar={"enc_layers": 2, "dec_layers": 2},
                             timeout=400, new_tokens=24, steps=4)
    rep = tp_card.check(spec, outs, n_layers=2, dec_layers=2, spk_layers=3)
    assert rep["heads_per_rank"] == {"ar": 12, "nar": 8}
    for held in rep["held_against_twins_per_rank"]:
        assert {s[:2] for s in held["decode_attention"]["shapes"]} == {
            ((1, 12, 64), (1, 145, 12, 64))}
        assert {s[0] for s in held["mha"]["shapes"]} == {(2, 725, 8, 64), (2, 526, 8, 64)}
        assert all(s[2] for s in held["mha"]["shapes"])
        assert held["mha"]["calls"] == rep["k1_want"]


def test_graft_entry_runs_the_mars5_ar_on_the_card(dev):
    """``graft_entry.entry()``: the 26-layer MARS5-width bf16 AR on the card
    gives finite (1, 64, 24,000) logits."""
    from mars5_tts_torch.graft_entry import entry

    fn, args = entry()
    assert args[0].embed.weight.is_cuda
    out = fn(*args)
    assert out.shape == (1, 64, 24_000) and bool(torch.isfinite(out).all())


def _graph_nar(dev, dec_layers, seed=0):
    """A W8A8 NAR at the released widths (D 1024, 16 heads, FFN 3072) on the
    card, bf16, with ``dec_layers`` decoder layers."""
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.quant import quantize_nar

    cfg = ResidualTransformerConfig(n_text_vocab=64, enc_layers=2, dec_layers=dec_layers,
                                    n_spk_layers=1)
    with torch.device(dev):
        nar = ResidualTransformer(cfg).init_(torch.Generator(device=dev).manual_seed(seed))
        return quantize_nar(nar.to(torch.bfloat16).eval())


def _launches():
    from mars5_tts_torch.ops.kernels import mha as K, nar_fused as F

    return (K.launch_count, F.fused_linear_launches, F.fused_ffn_launches)


@pytest.mark.parametrize("rows,offset,gen,ragged,sites", [
    (2, 533, 192, False, None),                 # CFG rows, 725 frames
    (1, 533, 192, False, None),                 # cond-only
    (2, 432, 768, False, None),                 # 1,200 frames
    (1, 432, 768, False, None),
    (2, 0, 725, False, None),                   # q_tail_start 0
    (2, 533, 192, True, None),                  # a ragged batch: padded rows, no slice
    (2, 533, 192, False, ("qkv", "caq")),       # no K4: the stack is one graph
    (2, 533, 192, False, ("qkv", "saout", "caq", "caout", "ffn")),
])
def test_graphed_decoder_bitwise_eager(dev, rows, offset, gen, ragged, sites):
    """``decoder_apply`` through ``DecoderGraphs`` at the served geometries
    equals the eager stack bit for bit at its first call (eager, then
    captured) and at two replays on other inputs; the kernels' launch
    counters read as the eager calls'."""
    from mars5_tts_torch.models import nar_graphs as G
    from mars5_tts_torch.models.layers import DEFAULT_OPTIONS, NarOptions

    nar = _graph_nar(dev, 2)
    options = DEFAULT_OPTIONS if sites is None else NarOptions(sites=sites)
    length, lc = offset + gen, 66
    g = torch.Generator(device=dev).manual_seed(length + rows)
    xpm = torch.zeros((rows, length), dtype=torch.bool, device=dev)
    cpad = torch.zeros((rows, lc), dtype=torch.bool, device=dev)
    cpad[-1, lc - 7:] = True
    q_tail = offset
    if ragged:
        xpm[-1, length - 101:] = True
        q_tail = 0
    steps = [(torch.randint(0, 1025, (rows, length, 8), generator=g, device=dev),
              torch.randn((1, 1024), generator=g, device=dev).to(torch.bfloat16).expand(rows, -1),
              torch.randn((rows, lc, 1024), generator=g, device=dev).to(torch.bfloat16))
             for _ in range(3)]
    G.reset_counts()
    graphs = G.DecoderGraphs()
    with torch.inference_mode():
        for i, (x, t_dec, mem) in enumerate(steps):
            n0 = _launches()
            want = nar.decoder_apply(x, xpm, t_dec, mem, cpad, q_tail_start=q_tail,
                                     options=options).clone()
            n1 = _launches()
            got = nar.decoder_apply(x, xpm, t_dec, mem, cpad, q_tail_start=q_tail,
                                    options=options, graphs=graphs)
            torch.cuda.synchronize()
            n2 = _launches()
            assert got.shape == (rows, length - q_tail, 1024)
            assert torch.equal(got, want), i
            assert [b - a for a, b in zip(n0, n1)] == [b - a for a, b in zip(n1, n2)], i
    assert (G.graph_captures, G.graph_replays) == (1, 2)
    assert len(graphs._geometries) == 1


def test_graphed_trajectory_bitwise_eager(dev, monkeypatch):
    """A deep-clone trajectory at T = 20 with CFG over t < 10 on the
    16-layer released-width W8A8 decoder, one generator seed: the grid with
    the graphs is the eager one; two captures (2 rows, 1 row), the other 18
    decoder calls replays; ``layers.fused_ffn`` called 16 times a step either
    way (what ``roofline.K4`` reads a call at a time); a second graphed
    trajectory reserves no more device memory than the first left."""
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models import layers, nar_graphs as G

    nar = _graph_nar(dev, 16)
    T, lc, lx = 20, 533, 192
    r = np.random.default_rng(20)
    x = np.repeat(r.integers(0, 1024, lx)[None, :, None], 8, axis=2)
    batch = (r.integers(0, 64, (1, 66)), r.integers(0, 1024, (1, lc, 8)), np.asarray([66]),
             np.asarray([lc]), x, np.zeros((1, lx), bool))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=2,
              guidance_interval=(0.0, 0.5))
    k4_calls = []
    k4 = layers.fused_ffn
    monkeypatch.setattr(layers, "fused_ffn", lambda *a, **kw: k4_calls.append(1) or k4(*a, **kw))

    def run():
        k4_calls.clear()
        G.reset_counts()
        grid = perform_simple_inference(nar, batch, MultinomialDiffusion(1025, T, device=dev),
                                        T, dsh, generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        return grid, len(k4_calls), (G.graph_captures, G.graph_replays)

    graphed = run()
    with monkeypatch.context() as m:
        m.setattr(G.DecoderGraphs, "takes", lambda *a: False)
        eager = run()
    assert torch.equal(graphed[0], eager[0])
    assert graphed[1] == eager[1] == 16 * T
    assert graphed[2] == (2, T - 2) and eager[2] == (0, 0)
    # each trajectory's graph pool goes back to the card when it is dropped
    reserved = torch.cuda.memory_reserved(dev)
    again = run()
    assert torch.equal(again[0], eager[0]) and again[2] == (2, T - 2)
    assert torch.cuda.memory_reserved(dev) == reserved


# ------------------------------------------------------------ K10

def _moe_case(rows, dev, seed, e=64, f=1408, d=2048, k=6, fs=2816):
    """DeepSeek-V2-Lite's widths: routed experts (E, 2F, D) / (E, D, F), the
    shared pair (Fs, D) / (D, Fs), rows routed by a softmax over E."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape, fan):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * fan ** -0.5).to(
            torch.bfloat16)

    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    gate = u(e, d, fan=d)
    p = torch.softmax(x.float() @ gate.float().t(), dim=-1)
    w, ids = torch.topk(p, k, dim=-1)
    return (x, ids.to(torch.int32), w, u(e, 2 * f, d, fan=d), u(e, d, f, fan=f),
            u(fs, d, fan=d), u(fs, d, fan=d), u(d, fs, fan=fs))


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_moe_decode_kernel_matches_twin(dev, rows):
    """K10 against its twin on the card at 1-8 rows, within one bf16 ulp
    (bitwise but where an f64 sum in another order crosses an f32 rounding
    boundary), with the same expert-load tally; one launch a call."""
    from mars5_tts_torch.ops.kernels import moe_decode as K

    args = _moe_case(rows, dev, seed=rows)
    loads = [torch.zeros(64, dtype=torch.int32, device=dev) for _ in range(2)]
    n0 = K.launch_count
    got = K.moe_decode(*args, load=loads[0])
    torch.cuda.synchronize()
    assert K.launch_count == n0 + 1
    want = K.moe_decode_ref(*args, load=loads[1])
    assert torch.equal(loads[0], loads[1])
    err = (got.float() - want.float()).abs()
    assert bool((err <= K.one_ulp(got, want)).all()), err.max().item()
    assert float((got != want).float().mean()) < 0.01
    with pytest.raises(ValueError):
        K.moe_decode(args[0].float(), *args[1:])


def _latent_ar(dev):
    """A DeepSeek-V2-shaped AR on the card (dim 256, so K10 takes it) and a
    two-row latent ring after its prefill."""
    from mars5_tts_torch.models import ar_decode as AD
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig

    cfg = CodecLMConfig(n_vocab=1400, dim=256, n_heads=4, n_kv_heads=4, head_dim=48,
                        n_layers=3, hidden_dim=512, sliding_window=4096, norm_eps=1e-6,
                        spk_hidden_dim=512, attention="mla", kv_lora_rank=64,
                        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                        rope_factor=40.0, rope_mscale=0.707, rope_mscale_all_dim=0.707,
                        n_routed_experts=8, n_shared_experts=2, n_experts_per_tok=2,
                        moe_hidden_dim=64, first_k_dense=1)
    m = CodecLM(cfg).init_(torch.Generator().manual_seed(0)).to(dev, torch.bfloat16).eval()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1283, 30), rng.integers(0, 1283, 21)]
    _, states = AD.prefill_rows(m, prompts, [rng.integers(0, 1024, (40, 8))] * 2, 4096)
    cache = AD.make_cache(cfg, 2, 200, torch.bfloat16, dev)
    for r, st in enumerate(states):
        cache.write_prompt(r, st)
    return m, cache


def _latent_state(m, cache, s):
    """A decode state over ``_latent_ar``'s two rows, their first tokens
    drawn."""
    from mars5_tts_torch.models import ar_decode as AD

    u = torch.rand((s.max_len, 2), generator=torch.Generator(device=cache.ckv.device
                                                             ).manual_seed(1),
                   device=cache.ckv.device)
    st = AD.new_state([np.arange(30), np.arange(21)], s, m.cfg.n_vocab, u, cache)
    logits = torch.randn((2, m.cfg.n_vocab), device=cache.ckv.device,
                         generator=torch.Generator(device=cache.ckv.device).manual_seed(2))
    AD.sample_update(st, logits, s, AD.rows_from_sampling(s, 2))
    return st


def _latent_sampling():
    from mars5_tts_torch.models.ar_decode import ArSampling

    return ArSampling(n_phones_gen=20, eos_idx=0, valid_start=258, valid_end=1283, max_len=150)


def _latent_probe(m, cache):
    """A ``LatentStep`` that keeps each logits tensor its body returns: the
    eager step's, then, once captured, the graph's static output, which each
    replay rewrites."""
    from mars5_tts_torch.models import ar_decode as AD

    class Probe(AD.LatentStep):
        def body(self, state):
            out = super().body(state)
            self.outs.append(out)
            return out

    step = Probe(m, cache)
    step.outs = []
    return step


@pytest.mark.parametrize("graphed", [True, False])
@torch.no_grad()
def test_latent_decode_step_has_no_host_sync(dev, monkeypatch, graphed):
    """A DeepSeek-V2-shaped AR's decode step on the card (latent ring, K10)
    runs with ``torch.cuda.set_sync_debug_mode("error")`` on: graphed, every
    step of the decode loop is one replay of the forward and the draw, and
    nothing but the loop's load of the device state and each step's token
    readback waits for the device; eager, ``decode_step`` on host tokens
    waits for nothing. Either way the logits are finite and K10's
    ``ar_expert_load`` tally holds every routed slot of every step."""
    from mars5_tts_torch.models import ar_decode as AD, ar_graphs as G
    from mars5_tts_torch.ops.kernels import moe_decode as K

    m, cache = _latent_ar(dev)
    if not graphed:
        pos = np.array([31, 22])
        AD.decode_step(m, np.array([5, 6]), pos, cache)     # first use: tables
        n0 = K.launch_count
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(1, 4):
                out = AD.decode_step(m, np.array([7, 8]), pos + i, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(out).all()
        assert K.launch_count == n0 + 3 * 2            # one a step and expert layer
        assert int(AD.expert_load(m)[1:].sum()) == 4 * 2 * 2 * 2
        return

    def quiet(fn):
        def run(*a):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return run

    s = _latent_sampling()
    st = _latent_state(m, cache, s)
    rows = AD.rows_from_sampling(s, 2)
    step = _latent_probe(m, cache)
    AD.decode_loop(st, s, rows, step, n_steps=2)            # eager, then captured
    G.reset_counts()
    n0 = K.launch_count
    monkeypatch.setattr(AD, "load_device_state", quiet(AD.load_device_state))
    monkeypatch.setattr(AD, "read_back", quiet(AD.read_back))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        AD.decode_loop(st, s, rows, step, n_steps=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (G.graph_captures, G.graph_replays) == (0, 3)
    assert K.launch_count == n0 + 3 * 2
    assert torch.isfinite(step.outs[-1]).all()             # the last replay's logits
    # 2 + 3 forwards of 2 rows, 2 expert layers, top-2
    assert int(AD.expert_load(m)[1:].sum()) == 5 * 2 * 2 * 2


@torch.no_grad()
def test_latent_graph_replays_the_eager_step(dev, monkeypatch):
    """Ten decode steps of two rows through the decode loop, the forward and
    the draw one CUDA graph replay a step, give the eager steps' logits,
    tokens, counts and rings bit for bit; one capture, nine replays."""
    from mars5_tts_torch.models import ar_decode as AD, ar_graphs as G

    runs, takes = [], G.takes
    for graphed in (False, True):
        monkeypatch.setattr(G, "takes", takes if graphed else (lambda state, route: False))
        G.reset_counts()
        m, cache = _latent_ar(dev)
        s = _latent_sampling()
        st = _latent_state(m, cache, s)
        rows = AD.rows_from_sampling(s, 2)
        step, logits = _latent_probe(m, cache), []
        for _ in range(10):         # a step a loop: each step's logits read after it
            n = len(step.outs)
            AD.decode_loop(st, s, rows, step, n_steps=1)
            logits.append(step.outs[min(n, len(step.outs) - 1)].clone())
        runs.append((torch.stack(logits), st.tokens.copy(), st.counts.clone(),
                     cache.ckv.clone()))
        assert (G.graph_captures, G.graph_replays) == ((1, 9) if graphed else (0, 0))
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    assert torch.equal(runs[0][3], runs[1][3])


@torch.no_grad()
def test_speaker_encoder_heads_of_128_skip_k1(dev):
    """A 601-token speaker encoder at 16 heads of 128 (the DeepSeek-V2 AR's)
    runs on the card without K1; the MARS5 AR's 24 heads of 64 take it."""
    from mars5_tts_torch.models.layers import TransformerEncoder
    from mars5_tts_torch.ops.kernels import mha as K1

    for dim, heads, launches in ((2048, 16, 0), (1536, 24, 2)):
        enc = TransformerEncoder(dim, heads, 6144, 2).to(dev, torch.bfloat16).eval()
        n0 = K1.launch_count
        out = enc(torch.randn(1, 601, dim, device=dev, dtype=torch.bfloat16))
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert K1.launch_count - n0 == launches


def _released_ar(dev, seed=5):
    """The MARS5 AR at its released widths (1536, 24 heads of 64, SwiGLU
    3584, 24,000 ids) with two layers, bf16 on the card."""
    import dataclasses

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig

    cfg = dataclasses.replace(CodecLMConfig.mars5(24_000), n_layers=2)
    with torch.device(dev):
        return CodecLM(cfg).init_(torch.Generator(device=dev).manual_seed(seed)).to(
            torch.bfloat16).eval()


def _fused_run(model, fp, dims, prompts, spks, s, u, est, rows=None, graphed=True):
    """A quantized batched call, graphed or eager: (its rows' (tokens,
    n_gen), the decode state, the counters' and K2's / K8's counts)."""
    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F, ar_graphs as G
    from mars5_tts_torch.ops.kernels import decode_layer as D, head4 as H

    states, loop, takes = [], AD.decode_loop, G.takes
    AD.decode_loop = lambda st, *a, **k: states.append(st) or loop(st, *a, **k)
    G.takes = takes if graphed else (lambda state, route: False)
    G.reset_counts()
    n0 = (D.launch_count, H.launch_count)
    try:
        out = AD.ar_generate_batched(model, prompts, spks, sampling=s, uniforms=u, est_lens=est,
                                     rows=rows, engine=F.FusedEngine(fp, dims))
    finally:
        AD.decode_loop, G.takes = loop, takes
    torch.cuda.synchronize()
    return out, states[-1], (G.graph_captures, G.graph_replays,
                             D.launch_count - n0[0], H.launch_count - n0[1])


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("wbits,head4", [(8, False), (4, False), (4, True)])
@torch.no_grad()
def test_graphed_fused_step_bitwise_eager(dev, wbits, head4, rows):
    """The quantized engine's graphed decode step (K2 direct, the rest one
    replay a step) at the released widths, W8 and W4, the int8 head and K8,
    1-8 rows: every token, the penalty counts and the int8 rings bitwise the
    eager loop's; one capture, a replay at every later step, one K2 call a
    step (and one K8)."""
    from mars5_tts_torch.models.ar_decode import ArSampling
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused

    model = _released_ar(dev)
    r = np.random.default_rng(rows)
    spks = [r.integers(0, 1024, (n, 8)) for n in r.integers(20, 40, rows)]
    prompts = [np.concatenate([r.integers(0, 258, n), k[:12, 0] + 258])
               for n, k in zip(r.integers(5, 30, rows), spks)]
    s = ArSampling(n_phones_gen=30, eos_idx=0, valid_start=258, valid_end=1283,
                   max_len=max(len(p) for p in prompts) + 60)
    u = r.random((s.max_len, rows)).astype(np.float32)
    est = list(r.integers(0, 60, rows))
    fp, dims = prepare_fused(model, s.max_len, wbits, head4=head4, batch=rows)
    got = [_fused_run(model, fp, dims, prompts, spks, s, u, est, graphed=g) for g in (True, False)]
    (graphed, st_g, n_g), (eager, st_e, n_e) = got
    for (tg, ng), (te, ne) in zip(graphed, eager):
        np.testing.assert_array_equal(tg, te)
        assert ng == ne
    assert torch.equal(st_g.counts, st_e.counts)
    assert torch.equal(st_g.cache.k, st_e.cache.k) and torch.equal(st_g.cache.v, st_e.cache.v)
    assert torch.equal(st_g.cache.scales, st_e.cache.scales)
    steps = st_g.steps
    assert n_g == (1, steps - 1, steps, steps if head4 else 0)
    assert n_e == (0, 0, steps, steps if head4 else 0)


@torch.no_grad()
def test_graphed_fused_run_with_a_mid_run_eos(dev):
    """Four rows of 300 tokens at the released widths (W4, int8 head), each
    with its own sampling values: EOS is a token the rows draw (found by a
    first run with EOS outside the vocabulary window, its early-EOS factor
    0), so rows end mid-run at its first draw while the others decode on;
    graphed, every row equals the eager loop's and its solo run's."""
    import dataclasses

    from mars5_tts_torch.models.ar_decode import (ROW_FIELDS, ArSampling, RowSampling,
                                                  rows_from_sampling)
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused

    model = _released_ar(dev, seed=11)
    r = np.random.default_rng(11)
    spks = [r.integers(0, 1024, (30, 8)) for _ in range(4)]
    prompts = [np.concatenate([r.integers(0, 258, 12), k[:10, 0] + 258]) for k in spks]
    s = ArSampling(n_phones_gen=0, eos_idx=0, eos_penalty_factor=0.0, valid_start=258,
                   valid_end=1283, max_len=max(len(p) for p in prompts) + 300)
    over = [{"top_k": 40, "penalty_window": 20}, {"top_p": 0.5}, {"typical_p": 0.8},
            {"temperature": 1.1, "penalty_window": 0}]
    rows = RowSampling(**{n: np.concatenate([getattr(rows_from_sampling(s, 1, o), n)
                                             for o in over]) for n in ROW_FIELDS})
    u = r.random((s.max_len, 4)).astype(np.float32)
    fp, dims = prepare_fused(model, s.max_len, 4, batch=4)
    first, _, _ = _fused_run(model, fp, dims, prompts, spks, s, u, [0] * 4, rows)
    gen = first[0][0][len(prompts[0]):]
    seen = {}
    for i, t in enumerate(gen):
        seen.setdefault(int(t), i)
    eos = min(seen, key=lambda t: abs(seen[t] - 150))
    s = dataclasses.replace(s, eos_idx=eos)
    (graphed, st, n_g), (eager, _, _) = [
        _fused_run(model, fp, dims, prompts, spks, s, u, [0] * 4, rows, graphed=g)
        for g in (True, False)]
    assert n_g[:2] == (1, st.steps - 1)
    lens = [n for _, n in graphed]
    assert min(lens) < 300 and min(lens) < max(lens), lens
    dims1 = dataclasses.replace(dims, batch=1)
    for i, ((tg, ng), (te, ne)) in enumerate(zip(graphed, eager)):
        np.testing.assert_array_equal(tg, te, err_msg=f"row {i}")
        assert ng == ne
        one = RowSampling(**{n: getattr(rows, n)[i:i + 1] for n in ROW_FIELDS})
        (solo, n_solo), = _fused_run(model, fp, dims1, [prompts[i]], [spks[i]], s,
                                     u[:, i:i + 1], [0], one)[0]
        np.testing.assert_array_equal(tg, solo, err_msg=f"row {i} solo")


@torch.no_grad()
def test_graphed_latent_route_bitwise_eager_at_one_row(dev, monkeypatch):
    """The DeepSeek-V2-shaped AR through ``ar_generate`` at one row, its
    step and draw one replay: the eager loop's tokens; one capture, a replay
    at every later step, K10's count the eager run's."""
    from mars5_tts_torch.models import ar_decode as AD, ar_graphs as G
    from mars5_tts_torch.ops.kernels import moe_decode as K

    m, _ = _latent_ar(dev)
    r = np.random.default_rng(3)
    prompt, spk = r.integers(0, 1283, 30), r.integers(0, 1024, (40, 8))
    s = AD.ArSampling(n_phones_gen=40, eos_idx=0, valid_start=258, valid_end=1283, max_len=130)
    u = r.random(s.max_len).astype(np.float32)
    runs = []
    takes = G.takes
    for graphed in (True, False):
        monkeypatch.setattr(G, "takes", takes if graphed else (lambda state, route: False))
        AD.reset_counts()
        n0 = K.launch_count
        tok, n = AD.ar_generate(m, prompt, spk, sampling=s, uniforms=u)
        runs.append((tok, n, G.graph_captures, G.graph_replays, K.launch_count - n0))
    (tg, ng, cg, rg, kg), (te, ne, ce, re_, ke) = runs
    np.testing.assert_array_equal(tg, te)
    # the steps launched: one past an EOS that ends the call too
    steps = ng - (len(tg) >= s.max_len) + AD.discarded_steps
    assert ng == ne and (cg, rg, ce, re_) == (1, steps - 1, 0, 0)
    assert kg == ke >= 2 * steps                # the replays count their K10 calls


@torch.no_grad()
def test_graphed_fused_pool_rows_equal_solo_runs(dev):
    """A four-row ``ContinuousBatcher`` on the quantized engine (W4) over six
    requests at the released widths: graphed, each request's tokens equal
    its solo graphed ``ar_generate`` run; the pool captures once for all its
    quanta (its inserts write the device state in place), K2 once a step."""
    from mars5_tts_torch.models import ar_graphs as G
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    model = _released_ar(dev, seed=7)
    r = np.random.default_rng(7)
    s = ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283, max_len=120)
    reqs = [Request(prompt=r.integers(0, 1283, n), spk_codes=r.integers(0, 1024, (20, 8)),
                    uniforms=r.random(120).astype(np.float32)) for n in (10, 50, 20, 45, 30, 15)]
    engine = FusedEngine(*prepare_fused(model, s.max_len, 4, batch=4))
    pool = ContinuousBatcher(model, s, engine=engine, batch_size=4, chunk_steps=16,
                             prompt_buckets=(32, 64), spk_bucket=32)
    for q in reqs:
        pool.submit(q)
    G.reset_counts()
    n0 = D.launch_count
    pool.run()
    assert D.launch_count - n0 == pool.steps_run and pool.chunks_run > 2
    assert (G.graph_captures, G.graph_replays) == (1, pool.steps_run - 1)
    for i, q in enumerate(reqs):
        ref, n = ar_generate(model, q.prompt, q.spk_codes, sampling=s, uniforms=q.uniforms,
                             engine=engine)
        np.testing.assert_array_equal(q.tokens, ref, err_msg=f"request {i}")
        assert q.n_gen == n


@torch.no_grad()
def test_graphed_fused_step_launches(dev):
    """A traced one-row call at the released widths (W4, int8 head): each
    replayed decode step (``mars5.ar.step`` without a capture in it) makes
    at most 20 launch calls of its own thread: K2's wrapper and K2 (the
    eager step made 116)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused

    model = _released_ar(dev)
    r = np.random.default_rng(2)
    prompt, spk = r.integers(0, 1283, 40), r.integers(0, 1024, (30, 8))
    s = ArSampling(n_phones_gen=100, eos_idx=0, valid_start=258, valid_end=1283, max_len=140)
    engine = FusedEngine(*prepare_fused(model, s.max_len, 4))
    u = r.random(s.max_len).astype(np.float32)
    ar_generate(model, prompt, spk, sampling=s, uniforms=u, engine=engine)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ar_generate(model, prompt, spk, sampling=s, uniforms=u, engine=engine)
    evs = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CPU]

    def spans(name):
        return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs if e.name() == name]

    captures = spans("mars5.ar.graph_capture")
    steps = [(a, b) for a, b in spans("mars5.ar.step")
             if not any(a <= c < b for c, _ in captures)]
    launches = np.sort([e.start_ns() for e in evs
                        if e.name().startswith(("cudaLaunch", "cuLaunch"))])
    per = [np.searchsorted(launches, b) - np.searchsorted(launches, a) for a, b in steps]
    assert len(captures) == 1 and len(steps) > 50
    assert max(per) <= 20, per


def _series_and_pipelined(monkeypatch, cls, run):
    """``run()`` (which returns a decode state) with ``cls.pipelined`` as it
    is, then patched False (the series loop): each time (the state, the
    host buffers its prefill made, ``pipelined_steps``, ``discarded_steps``,
    the graph captures and replays, K2's and K10's launches)."""
    from mars5_tts_torch.models import ar_decode as AD, ar_graphs as G
    from mars5_tts_torch.ops.kernels import decode_layer as D, moe_decode as K

    runs = []
    for serial in (False, True):
        with monkeypatch.context() as m:
            if serial:
                m.setattr(cls, "pipelined", False)
            AD.reset_counts()
            n0 = (D.launch_count, K.launch_count)
            state, host = run()
            torch.cuda.synchronize()
            runs.append((state, host, AD.pipelined_steps, AD.discarded_steps, G.graph_captures,
                         G.graph_replays, D.launch_count - n0[0], K.launch_count - n0[1]))
    return runs


@pytest.mark.parametrize("rows", [1, 8])
@torch.no_grad()
def test_pipelined_fused_route_bitwise_the_series_loop(dev, monkeypatch, rows):
    """The graphed W4A8 route at the released widths, launched one step
    ahead of its readback, against the same route in series: EOS forced
    mid-run in the even rows, the odd ones capped; tokens, penalty counts
    and the capped rows' rings bitwise; one capture a state; one K2 launch
    a step, and one more only where an EOS ends the call; every step but
    the first launched ahead; the pinned readback buffers the prefill made
    kept to the end."""
    from torch_port_fixtures import Forcing

    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F

    model = _released_ar(dev)
    r = np.random.default_rng(rows + 20)
    spks = [r.integers(0, 1024, (n, 8)) for n in r.integers(20, 40, rows)]
    prompts = [np.concatenate([r.integers(0, 258, n), k[:12, 0] + 258])
               for n, k in zip(r.integers(5, 30, rows), spks)]
    s = AD.ArSampling(n_phones_gen=30, eos_idx=1282, valid_start=258, valid_end=1283,
                      max_len=max(len(p) for p in prompts) + 80)
    u = torch.as_tensor(r.random((s.max_len, rows)).astype(np.float32), device=dev)
    at = [0 if b % 2 else 20 + 7 * b for b in range(rows)]
    engine = Forcing(F.FusedEngine(*F.prepare_fused(model, s.max_len, 4, batch=rows)),
                     s.eos_idx, at)

    def run():
        state = AD.prefill_state(model, s, prompts, spks, u, engine=engine)
        host = state.dev.host
        return AD.decode_chunk(model, s, state, None, engine=engine), host

    (got, host, pipe, drop, cap, rep, k2, _), (want, _, pipe0, drop0, cap0, rep0, k20, _) = \
        _series_and_pipelined(monkeypatch, F.FusedStep, run)
    for b, ((tg, ng), (tw, nw)) in enumerate(zip(got.results(), want.results())):
        np.testing.assert_array_equal(tg, tw, err_msg=f"row {b}")
        assert ng == nw and (ng == at[b] if at[b] else got.cur[b] == s.max_len), b
        if not at[b]:
            for name in ("k", "v", "scales"):
                assert torch.equal(getattr(got.cache, name)[:, b], getattr(want.cache, name)[:, b])
    assert torch.equal(got.counts, want.counts)
    assert (pipe0, drop0, cap0, rep0, k20) == (0, 0, 1, want.steps - 1, want.steps)
    assert drop == (rows == 1) and got.steps == want.steps + drop
    assert (pipe, cap, rep, k2) == (got.steps - 1, 1, got.steps - 1, got.steps)
    assert got.dev.host is host and host.is_pinned()


@pytest.mark.parametrize("end", ["eos", "cap"])
@torch.no_grad()
def test_pipelined_latent_route_bitwise_the_series_loop(dev, monkeypatch, end):
    """The DeepSeek-V2-shaped AR's graphed latent route at one row, one step
    ahead, against the same route in series: tokens, counts and the latent
    ring bitwise (the step takes its cursor from the device, so even the
    step thrown away past an EOS rewrites what its last step wrote); one
    capture; K10 once an expert layer a step launched."""
    from torch_port_fixtures import Forcing

    from mars5_tts_torch.models import ar_decode as AD

    m, _ = _latent_ar(dev)
    r = np.random.default_rng(4)
    prompt, spk = r.integers(0, 1283, 30), r.integers(0, 1024, (40, 8))
    s = AD.ArSampling(n_phones_gen=40, eos_idx=1282, valid_start=258, valid_end=1283,
                      max_len=130)
    u = torch.as_tensor(r.random((s.max_len, 1)).astype(np.float32), device=dev)
    engine = Forcing(AD.MODEL_ENGINE, s.eos_idx, [50 if end == "eos" else 0])

    def run():
        state = AD.prefill_state(m, s, [prompt], [spk], u, engine=engine)
        host = state.dev.host
        return AD.decode_chunk(m, s, state, None, engine=engine), host

    (got, host, pipe, drop, cap, rep, _, k10), (want, _, pipe0, drop0, _, _, _, k100) = \
        _series_and_pipelined(monkeypatch, AD.LatentStep, run)
    np.testing.assert_array_equal(got.results()[0][0], want.results()[0][0])
    assert got.n_gen[0] == want.n_gen[0] == (50 if end == "eos" else got.n_gen[0])
    assert torch.equal(got.counts, want.counts) and torch.equal(got.cache.ckv, want.cache.ckv)
    assert (pipe0, drop0) == (0, 0) and drop == (end == "eos")
    assert got.steps == want.steps + drop and (pipe, cap, rep) == (got.steps - 1, 1, got.steps - 1)
    assert k10 - k100 == 2 * drop and k100 >= 2 * want.steps   # two expert layers
    assert got.dev.host is host and host.is_pinned()


def test_readback_waits_for_a_state_on_another_card(dev):
    """A decode state on the second card while the first is current: its
    readback waits for the copy queued behind a long kernel there, so it
    reads the tokens written after that kernel, never the zeros before."""
    from mars5_tts_torch.models.ar_decode import DeviceState

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    state = DeviceState(2, 8, torch.device("cuda", 1))
    with torch.cuda.device(1):
        torch.cuda._sleep(2 * 10 ** 9)       # about a second of the second card's clock
        state.out.fill_(7)
    state.post(0)
    assert torch.cuda.current_device() == 0
    np.testing.assert_array_equal(state.fetch(0), np.full((2, 2), 7))
    torch.cuda.synchronize(1)


@pytest.mark.parametrize("rows", [2, 3, 8])
@torch.no_grad()
def test_k2_rows_do_not_depend_on_the_attention_split(dev, rows):
    """K2 at the released widths (W4): the last row moved one position on,
    so that ``attention_split``'s chunks change (it is sized by the largest
    position), leaves every other row's h, k_new and v_new bitwise as they
    were. A row that drew EOS runs its dropped step at cursor + 1, so it
    cannot change the rows beside it."""
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D

    cfg = CodecLMConfig.mars5(24_000)
    fp, dims = prepare_fused(_decode_model(cfg, dev, 4), 2000, 4)
    g = torch.Generator(device=dev).manual_seed(rows)
    shape = (dims.n_layers, rows, dims.window, dims.dim)
    (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.randn(shape, generator=g, device=dev) * 0.1)
                          for _ in range(2))
    kvs = torch.stack([ks, vs], dim=2).contiguous()
    x = fp["embed"][torch.arange(rows, device=dev) * 5 + 11].to(torch.bfloat16)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for last in (639, 1151, 1663):
        base = [100 + (last - 200) * b // rows for b in range(rows - 1)]
        splits = [D.attention_split(sm, rows, dims.n_heads, min(p + 1, dims.window))
                  for p in (last, last + 1)]
        assert splits[0] != splits[1], (last, splits)
        a, b_ = (D.fused_decode_layers(fp, x, base + [p], ck, cv, kvs, dims=dims,
                                       norm_eps=cfg.norm_eps) for p in (last, last + 1))
        torch.cuda.synchronize()
        for ta, tb in zip(a, b_):
            assert torch.equal(ta[..., : rows - 1, :], tb[..., : rows - 1, :]), (last, splits)
