"""Kernel K9 ``mega_decoder_stack`` (its plain twin and operand bundle) and
the ``nar_mega`` route, against the JAX package's ``ops/pallas/nar_mega.py``
at a geometry its gate takes: D = 256, 4 heads of 64, F = 768, 2 layers,
L = 100, Lk = 19, with both key-padding masks.

* The port's pack, scales, biases and LN vectors equal JAX ``build_mega_pack``
  stage by stage (the port keeps lin2 as (D, F); JAX cuts it into K-chunks).
* The twin agrees with the JAX emulation twin and with the Pallas kernel in
  interpret mode within 0.03 x max|want| (the JAX kernel tests' bound). The
  exactly-equal share is measured (0.35 against the twin, 0.46 against the
  kernel; the JAX kernel and its own twin agree on 0.35): the port sums the
  LN statistics and the softmax denominators in f64, XLA in f32 in its own
  order, and a one-ulp bf16 flip moves an int8 activation.
* Given the same inputs, each GEMM stage is bit-identical to the JAX math.
* The per-layer W8A8 stack agrees with the mega stack within 0.05 x max
  (cross-attention is the flash form in K9, the documented divergence).
* Masked rows do not reach valid rows.
* A torch emulation of the kernel's two-pass attention (128-key tiles, the
  max first, then p, its f64 sum and P V tile by tile) agrees with the
  twin's ``_attn`` within one bf16 ulp, and in the twin with the JAX
  ``mega_decoder_stack_ref`` within the JAX kernel tests' bound.
* The W8A8 trajectory with the mega pack against the JAX engine with
  ``MARS5_NAR_MEGA_INTERPRET=1`` under shared uniforms, and
  ``Mars5TTS(nar_backend="int8", nar_mega=True)`` against the JAX pipeline
  so set, with shared AR uniforms and NAR draws: L0 identical, at most 4% of
  the grid cells apart (the port's bound for the W8A8 NAR against JAX),
  finite audio.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import port_config, tiny_models  # noqa: E402

D, F, NH, L, LK = 256, 768, 4, 100, 19
EPS = 4e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return t(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()


@functools.lru_cache(maxsize=None)
def _nar(n_layers: int = 2):
    """A JAX NAR at the gate's geometry with the decoder's LN affines and
    biases moved off 1 / 0, quantized by the JAX package and carried into the
    port by the converter: (JAX config, JAX quantized params, port module,
    the JAX f32 params)."""
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig as PCfg

    cfg = ResidualTransformerConfig(n_text_vocab=259, dim=D, nhead=NH, enc_layers=1,
                                    dec_layers=n_layers, n_spk_layers=1, t_emb_dim=64,
                                    hidden_dim=F)
    p = jax.tree.map(np.asarray, init_nar(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(8)
    lay = p["decoder"]["layers"]
    for k in list(lay):
        if k.startswith("norm") or k.endswith("_b"):
            base = 1.0 if k.endswith("_w") else 0.0
            lay[k] = (base + 0.05 * rng.standard_normal(lay[k].shape)).astype(np.float32)
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, p)))
    pcfg = port_config(cfg, PCfg)
    return cfg, pq, load_nar(nar_reference_state_dict(pq, pcfg), pcfg), p


@pytest.fixture(scope="module")
def stack():
    """JAX layers, the port's pack, and bf16 inputs with both masks."""
    from mars5_tts_torch.ops.kernels.nar_mega import build_mega_pack

    _, pq, port, _ = _nar()
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, L, D)).astype(np.float32), jnp.bfloat16)
    mem = jnp.asarray(rng.standard_normal((2, LK, D)).astype(np.float32), jnp.bfloat16)
    kpm = np.zeros((2, L), bool)
    kpm[1, 90:] = True
    mpm = np.zeros((2, LK), bool)
    mpm[0, 15:] = True
    return (jax.tree.map(jnp.asarray, pq["decoder"]["layers"]),
            build_mega_pack(port.tfm.decoder), x, mem, kpm, mpm)


def test_mega_pack_equals_jax_stage_by_stage(stack):
    from mars5_tts_tpu.ops.pallas.nar_mega import MegaDims, build_mega_pack

    layers, mp, *_ = stack
    jp = build_mega_pack(layers)
    jd = MegaDims(n_layers=2, dim=D, nhead=NH, head_dim=64, hidden=F, batch=2, seq=L,
                  mem_len=LK)
    pack = np.asarray(jp["pack"]).reshape(2, jd.rpl, D)
    for i in range(2):
        for c in range(6):
            o, r = jd.stage_offsets[c], jd.stage_rows[c]
            np.testing.assert_array_equal(mp.weight(i, c).numpy(), pack[i, o:o + r])
        # lin2: JAX rows [cD, (c+1)D) hold columns [cD, (c+1)D) of (D, F)
        chunks = pack[i, jd.stage_offsets[6]:].reshape(F // D, D, D)
        np.testing.assert_array_equal(mp.weight(i, 6).numpy(),
                                      np.concatenate(list(chunks), axis=1))
    np.testing.assert_array_equal(mp.svec.numpy(), np.asarray(jp["svec"]))
    np.testing.assert_array_equal(mp.bvec.numpy(), np.asarray(jp["bvec"]))
    np.testing.assert_array_equal(mp.lnvec.numpy(), np.asarray(jp["lnvec"]))


def _port_ref(mp, x, mem, kpm, mpm):
    from mars5_tts_torch.ops.kernels.nar_mega import mega_decoder_stack

    out = mega_decoder_stack(mp, _bf16(x), _bf16(mem), t(kpm), t(mpm), eps=EPS)
    assert out.dtype == torch.bfloat16 and out.shape == (2, L, D)
    return out.float().numpy()


@pytest.mark.parametrize("against,floor", [("emulation", 0.25), ("interpret", 0.35)])
def test_mega_ref_matches_jax(stack, against, floor):
    from mars5_tts_tpu.ops.pallas.nar_mega import mega_decoder_stack, mega_decoder_stack_ref

    layers, mp, x, mem, kpm, mpm = stack
    if against == "emulation":
        fn = jax.jit(functools.partial(mega_decoder_stack_ref, nhead=NH, eps=EPS))
        want = fn(layers, x, mem, tgt_key_padding_mask=jnp.asarray(kpm),
                  memory_key_padding_mask=jnp.asarray(mpm))
    else:
        want = mega_decoder_stack(layers, x, mem, NH, jnp.asarray(kpm), jnp.asarray(mpm),
                                  eps=EPS, interpret=True)
    w = np.asarray(want.astype(jnp.float32))
    g = _port_ref(mp, x, mem, kpm, mpm)
    scale = np.abs(w).max()
    np.testing.assert_allclose(g, w, rtol=0, atol=0.03 * scale)
    assert np.abs(g - w).mean() < 8e-3 * scale
    exact = (g == w).mean()
    print(f"exactly equal to the JAX {against}: {exact:.4f}")
    assert exact > floor


def _jax_gemm(xf, w, s, b):
    """The JAX twin's stage GEMM, op by op (no jit, so no FMA contraction)."""
    from mars5_tts_tpu.ops.pallas.nar_fused import _quant_rows

    xq, xs = _quant_rows(xf)
    acc = jax.lax.dot_general(xq, w, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (xs * s)
    return y if b is None else y + b


@pytest.mark.parametrize("stage", range(7))
def test_mega_gemm_stages_bit_identical(stack, stage):
    """Stage ``stage`` of layer 1 (qkv, sa_out, ca_q, ca_kv, ca_out, WV, lin2)
    on the same f32 input: the port's twin GEMM on its pack gives the JAX
    twin's bits on the JAX pack."""
    from mars5_tts_tpu.ops.pallas.nar_mega import MegaDims, build_mega_pack
    from mars5_tts_torch.ops.kernels.nar_mega import _gemm

    layers, mp, *_ = stack
    jp = build_mega_pack(layers)
    jd = MegaDims(n_layers=2, dim=D, nhead=NH, head_dim=64, hidden=F, batch=2, seq=L,
                  mem_len=LK)
    pack = jp["pack"].reshape(2, jd.rpl, D)
    k = F if stage == 6 else D
    xf = np.random.default_rng(stage).standard_normal((37, k)).astype(np.float32)
    so, sw = jd.s_offsets[stage], jd.s_widths[stage]
    s = jp["svec"][1:2, so:so + sw]
    bi = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 6: 5}.get(stage)
    b = None if bi is None else jp["bvec"][1:2, jd.b_offsets[bi]:jd.b_offsets[bi] + sw]
    o, r = jd.stage_offsets[stage], jd.stage_rows[stage]
    if stage == 6:      # JAX sums the F / D K-chunk products in int32
        from mars5_tts_tpu.ops.pallas.nar_fused import _quant_rows
        xq, xs = _quant_rows(jnp.asarray(xf))
        acc = sum(jax.lax.dot_general(xq[:, c * D:(c + 1) * D],
                                      pack[1, o + c * D:o + (c + 1) * D],
                                      (((1,), (1,)), ((), ())),
                                      preferred_element_type=jnp.int32)
                  for c in range(F // D))
        want = acc.astype(jnp.float32) * (xs * s) + b
    else:
        want = _jax_gemm(jnp.asarray(xf), pack[1, o:o + r], s, b)
    got = _gemm(t(xf), mp.weight(1, stage), mp.scale(1, stage),
                None if bi is None else mp.bias(1, stage))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_layer_stack_matches_mega(stack):
    """The port's per-layer W8A8 stack (K3/K4 twins, the unfused sites, K1's
    twin and the dense cross-attention) and the mega twin, both through the
    final LayerNorm, on the valid rows."""
    from mars5_tts_torch.ops.kernels.nar_mega import mega_decoder_stack_ref

    _, mp, x, mem, kpm, mpm = stack
    dec = _nar()[2].tfm.decoder
    xs, ms = _bf16(x), _bf16(mem)
    want = dec(xs, ms, t(kpm), t(mpm)).float().numpy()
    got = dec.norm(mega_decoder_stack_ref(mp, xs, ms, t(kpm), t(mpm))).float().numpy()
    g = np.concatenate([got[0].ravel(), got[1, :90].ravel()])
    w = np.concatenate([want[0].ravel(), want[1, :90].ravel()])
    scale = np.abs(w).max()
    np.testing.assert_allclose(g, w, rtol=0, atol=0.05 * scale)
    assert np.abs(g - w).mean() < 5e-3 * scale


def test_mega_mask_isolation(stack):
    """Valid-row outputs do not depend on the contents of masked rows."""
    _, mp, x, mem, kpm, mpm = stack
    base = _port_ref(mp, x, mem, kpm, mpm)
    x2 = x.at[1, 90:].set(jnp.bfloat16(7.0))
    mem2 = mem.at[0, 15:].set(jnp.bfloat16(-3.0))
    pert = _port_ref(mp, x2, mem2, kpm, mpm)
    np.testing.assert_array_equal(base[0], pert[0])
    np.testing.assert_array_equal(base[1, :90], pert[1, :90])


def _attn_two_pass(q, k, v, mask, c2):
    """A torch emulation of K9's attention kernel (``csrc/nar_mega.cu``
    ``mega_attn_kernel``): the keys in ring tiles of ``ATTN_KEYS`` with a 0 /
    -inf bias for masked keys and the ragged tail (zero-filled rows), pass 1
    each row's max tile by tile, pass 2 p = exp2((s - max) * c2), its row sum
    in f64 and P V (p rounded to bf16) accumulated tile by tile in f32, then
    o / sum. Arguments and result as the twin's ``_attn``."""
    from mars5_tts_torch.ops.kernels.nar_mega import ATTN_KEYS

    b, lq, h, dh = q.shape
    lk = k.shape[1]
    n = -(-lk // ATTN_KEYS) * ATTN_KEYS
    kp, vp = (torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, n - lk)) for a in (k, v))
    bias = torch.zeros((b, n))
    bias[:, lk:] = float("-inf")
    if mask is not None:
        bias[:, :lk] = bias[:, :lk].masked_fill(mask, float("-inf"))
    qf = q.float()

    def scores(t):
        sl = slice(t * ATTN_KEYS, (t + 1) * ATTN_KEYS)
        return torch.einsum("bqhd,bkhd->bhqk", qf, kp[:, sl]) + bias[:, None, None, sl], sl

    tiles = range(n // ATTN_KEYS)
    m = torch.stack([scores(t)[0].amax(-1) for t in tiles]).amax(0)[..., None]
    o = torch.zeros((b, h, lq, dh))
    r = torch.zeros((b, h, lq, 1), dtype=torch.float64)
    for t in tiles:
        s, sl = scores(t)
        p = torch.exp2((s - m) * c2)
        r += p.double().sum(-1, keepdim=True)
        o += torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vp[:, sl])
    return (o / r.float()).to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, lq, h * dh)


@pytest.mark.parametrize("lq,lk,masked", [(100, 19, True), (300, 300, True), (77, 130, False),
                                          (130, 66, True)])
def test_two_pass_attention_matches_the_twin(lq, lk, masked):
    """The kernel's two-pass, tile-by-tile attention against the twin's
    full-row ``_attn`` on the same bf16 q, k, v: the scores, the max and the
    f64 row sums are the same values; only the f32 P V sums run in another
    order (tile by tile), so each output is within one bf16 ulp of the
    twin's (|diff| <= 2^-7 x |twin|, the largest ulp a bf16 value v has
    relative to |v|) and at least 98% are equal (99.99% at 300 keys here)."""
    from mars5_tts_torch.ops.kernels.nar_mega import LOG2E, _attn

    g = torch.Generator().manual_seed(lq + lk)
    q, k, v = (torch.randn((2, n, NH, 64), generator=g).to(torch.bfloat16)
               for n in (lq, lk, lk))
    mask = None
    if masked:
        mask = torch.zeros((2, lk), dtype=torch.bool)
        mask[1, lk - lk // 5:] = True
        mask[0, 3] = True
    c2 = 0.125 * LOG2E
    got = _attn_two_pass(q, k, v, mask, c2).float()
    want = _attn(q, k, v, mask, c2).float()
    assert got.shape == want.shape == (2, lq, NH * 64)
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs()).all())
    assert (got == want).float().mean().item() >= 0.98


def test_two_pass_stack_matches_jax(stack, monkeypatch):
    """The twin with its attention replaced by the kernel's two-pass
    emulation, against the JAX ``mega_decoder_stack_ref``: within 0.03 x
    max|want| and a mean below 8e-3 x max|want| (the JAX kernel tests'
    bound, as ``test_mega_ref_matches_jax``)."""
    from mars5_tts_tpu.ops.pallas.nar_mega import mega_decoder_stack_ref
    from mars5_tts_torch.ops.kernels import nar_mega as M

    layers, mp, x, mem, kpm, mpm = stack
    want = np.asarray(jax.jit(functools.partial(mega_decoder_stack_ref, nhead=NH, eps=EPS))(
        layers, x, mem, tgt_key_padding_mask=jnp.asarray(kpm),
        memory_key_padding_mask=jnp.asarray(mpm)).astype(jnp.float32))
    monkeypatch.setattr(M, "_attn", _attn_two_pass)
    got = _port_ref(mp, x, mem, kpm, mpm)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03 * scale)
    assert np.abs(got - want).mean() < 8e-3 * scale


def _batch(rng, gen=24, n_prompt=13, text_len=9):
    x = np.repeat(rng.integers(0, 1024, gen)[None, :, None], 8, axis=2)
    return (rng.integers(0, 258, (1, text_len)), rng.integers(0, 1024, (1, n_prompt, 8)),
            np.asarray([text_len]), np.asarray([n_prompt]), x, np.zeros((1, gen), bool))


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_mega_trajectory_matches_jax_interpret(monkeypatch):
    """Injected uniforms, T = 4, deep clone with CFG: the port's W8A8 engine
    with ``mega`` (the K9 twin) against the JAX engine running its mega
    kernel in interpret mode; both packages take their mega route."""
    from mars5_tts_tpu.config import DSH
    from mars5_tts_tpu.ops.pallas import nar_mega as JM
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.diffusion.engine import _diffusion_scan, _diffusion_scan_serving
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.ops.kernels.nar_mega import build_mega_pack

    cfg, pq, port, _ = _nar()
    j_calls = _count_calls(monkeypatch, JM, "mega_decoder_stack")
    p_calls = _count_calls(monkeypatch, layers, "mega_decoder_stack")
    rng = np.random.default_rng(2)
    batch = _batch(rng)
    steps = 4
    dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True,
              jump_len=1, jump_n_sample=1, q0_override_steps=2,
              enable_kevin_scaled_inference=True)
    uni = rng.random((len(build_step_plan(steps)[0]), 2, 1, 13 + 24, 8, 1025)).astype(np.float32)
    x_init = rng.integers(0, 1025, (1, 24, 8))
    monkeypatch.setenv("MARS5_NAR_MEGA_INTERPRET", "1")
    # the env knob is read at trace time: drop cached traces before and after
    _diffusion_scan.clear_cache()
    _diffusion_scan_serving.clear_cache()
    try:
        want = np.asarray(j_infer(jax.tree.map(jnp.asarray, pq), cfg, batch, JDiff(1025, steps),
                                  steps, dsh, uniforms=uni, x_init=x_init))
    finally:
        _diffusion_scan.clear_cache()
        _diffusion_scan_serving.clear_cache()
    got = perform_simple_inference(port, batch, MultinomialDiffusion(1025, steps), steps, dsh,
                                   uniforms=uni, x_init=x_init,
                                   mega=build_mega_pack(port.tfm.decoder)).numpy()
    assert j_calls and len(p_calls) == steps      # JAX traces its step once
    assert got.shape == want.shape == (1, 24, 8)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (got != want).mean() <= 0.04


def test_mars5tts_nar_mega_request(monkeypatch):
    """``Mars5TTS(nar_backend="int8", nar_mega=True)``: a seeded request runs
    the stack through K9 (its twin here) once a reverse step, with finite
    audio and reproducibly, on an operand pack built once for both requests;
    the arguments K9 cannot take are refused."""
    from mars5_tts_torch import InferenceConfig, Mars5TTS, pipeline
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import vocos_from_pytree
    from mars5_tts_torch.ops.kernels import nar_mega
    from tests.torch_port_fixtures import make_tokenizers, port_codeclm

    cfgs, params = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    kw = dict(texttok=texttok, speechtok=speechtok,
              encodec=encodec_from_pytree(params["encodec"]),
              vocos=vocos_from_pytree(params["vocos"]))
    ar = port_codeclm(cfgs["ar"], params["ar"])
    nar = _nar()[2]
    tts = Mars5TTS.from_params(ar, nar, nar_backend="int8", nar_mega=True, **kw)
    ref = (np.random.default_rng(7).standard_normal(8 * 60) * 0.1).astype(np.float32)
    cfg = InferenceConfig(timesteps=4, generate_max_len_override=320, trim_db=200)
    calls = _count_calls(monkeypatch, layers, "mega_decoder_stack")
    packs = _count_calls(monkeypatch, pipeline, "build_mega_pack")
    n0 = nar_mega.launch_count
    runs = [tts.tts("hi there", ref, ref_transcript="ok", cfg=cfg, seed=3) for _ in range(2)]
    assert len(calls) == 2 * 4                 # once a reverse step
    assert len(packs) == 1                     # the pack is kept between requests
    assert nar_mega.launch_count == n0        # CPU tensors take the twin
    codes, audio = runs[0]
    assert len(audio) > 0 and np.isfinite(audio).all()
    assert 0 <= int(tts.last_grid.min()) and int(tts.last_grid.max()) <= 1024
    np.testing.assert_array_equal(runs[1][1], audio)
    big = ResidualTransformer(ResidualTransformerConfig(259, dim=D, nhead=NH, enc_layers=1,
                                                        dec_layers=1, n_spk_layers=1,
                                                        hidden_dim=F))
    with pytest.raises(ValueError):            # mega needs the int8 backend
        Mars5TTS.from_params(ar, big, nar_mega=True, **kw)
    with pytest.raises(ValueError):
        Mars5TTS.from_params(ar, big, nar_backend="int8", nar_tail="fused", **kw)
    tiny = ResidualTransformer(ResidualTransformerConfig.tiny(259))
    with pytest.raises(ValueError):            # head dim 16, D = 64: not K9's geometry
        Mars5TTS.from_params(ar, tiny, nar_backend="int8", nar_mega=True, **kw)


def test_mars5tts_nar_mega_matches_jax_pipeline(monkeypatch):
    """Both pipelines, bf16 AR + the int8 NAR through its mega route (the JAX
    one with ``MARS5_NAR_MEGA_INTERPRET=1``), with shared AR uniforms and
    NAR draws: identical AR codes and L0, grids within 4%, finite audio."""
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.diffusion.engine import _diffusion_scan, _diffusion_scan_serving
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_tpu.ops.pallas import nar_mega as JM
    from mars5_tts_torch import InferenceConfig, Mars5TTS
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree
    from tests.torch_port_fixtures import make_tokenizers, port_codeclm, port_nar

    monkeypatch.setenv("MARS5_NAR_MEGA_INTERPRET", "1")
    steps = 4
    u_ar = np.random.default_rng(9).random(4096).astype(np.float32)
    grids = {}

    def ar_with_uniforms(fn):
        def run(*a, sampling, seed=0, **k):
            return fn(*a, sampling=sampling, uniforms=u_ar[:sampling.max_len], **k)
        return run

    def nar_with_draws(fn, name, drop):
        def run(*a, **k):
            batch = a[2] if name == "jax" else a[1]
            n_prompt, gen = np.shape(batch[1])[1], np.shape(batch[4])[1]
            rng = np.random.default_rng(n_prompt * 1000 + gen)
            uni = rng.random((len(build_step_plan(steps)[0]), 2, 1, n_prompt + gen, 8,
                              1025)).astype(np.float32)
            for key in drop:
                k.pop(key, None)
            grids[name] = np.asarray(fn(*a, uniforms=uni,
                                        x_init=rng.integers(0, 1025, (1, gen, 8)), **k))
            return grids[name]
        return run

    monkeypatch.setattr(JP, "ar_generate", ar_with_uniforms(JP.ar_generate))
    monkeypatch.setattr(PP, "ar_generate", ar_with_uniforms(PP.ar_generate))
    monkeypatch.setattr(JP, "perform_simple_inference",
                        nar_with_draws(JP.perform_simple_inference, "jax",
                                       ("key", "gen_bucket", "text_bucket")))
    monkeypatch.setattr(PP, "perform_simple_inference",
                        nar_with_draws(PP.perform_simple_inference, "port", ("generator",)))
    j_calls = _count_calls(monkeypatch, JM, "mega_decoder_stack")
    p_calls = _count_calls(monkeypatch, layers, "mega_decoder_stack")

    cfgs, tiny = tiny_models()
    cfg, _, _, p = _nar()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(tiny["ar"], p, cfgs["ar"], cfg, texttok=texttok,
                                   speechtok=speechtok, encodec_params=tiny["encodec"],
                                   vocos_params=tiny["vocos"], encodec_cfg=cfgs["encodec"],
                                   vocos_cfg=cfgs["vocos"], nar_backend="int8")
    ptts = Mars5TTS.from_params(port_codeclm(cfgs["ar"], tiny["ar"]), port_nar(cfg, p),
                                texttok=texttok, speechtok=speechtok,
                                encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), nar_backend="int8",
                                nar_mega=True)
    ref = (np.random.default_rng(4).standard_normal(8 * 60) * 0.1).astype(np.float32)
    icfg = InferenceConfig(timesteps=steps, generate_max_len_override=100, trim_db=200)
    # the env knob is read at trace time: drop cached traces before and after
    _diffusion_scan.clear_cache()
    _diffusion_scan_serving.clear_cache()
    try:
        outs = {name: tts.tts("hi there", ref, ref_transcript="ok", cfg=icfg, seed=3)
                for name, tts in (("jax", jtts), ("port", ptts))}
    finally:
        _diffusion_scan.clear_cache()
        _diffusion_scan_serving.clear_cache()
    assert j_calls and len(p_calls) == steps
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert len(outs["port"][0]) > 0 and grids["port"].shape == grids["jax"].shape
    np.testing.assert_array_equal(grids["port"][..., 0], grids["jax"][..., 0])
    assert (grids["port"] != grids["jax"]).mean() <= 0.04
    assert np.isfinite(outs["port"][1]).all()
