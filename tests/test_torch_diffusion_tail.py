"""Kernels K6 ``heads_diffusion_tail`` and K5 ``diffusion_tail`` (their
plain twins), the per-step posterior scalars and the W8A8 diffusion engine,
against the JAX package.

* ``tail_scalars`` is bit-identical to the JAX package's.
* The K6 twin picks the same indices as the JAX Pallas kernel in interpret
  mode at t = 0, a middle t and T - 1, with and without CFG; so does the K5
  twin against the JAX ``diffusion_tail`` on the same bf16 logits, and the
  K5 twin on the folded heads' logits picks the K6 twin's indices.
* On the generator path the K6 route, the split route (folded heads, then
  K5) and the folded-heads dense route give identical grids (the same draws,
  the same float ops).
* Under one injected uniform stream, on the same ``quantize_nar`` weights
  carried across by the converter, the port's W8A8 trajectory gives the grid
  of the JAX package's (its fused decoder kernels in interpret mode) when the
  port's K3/K4 twins are swapped for those Pallas kernels. With the twins, a
  few grid cells flip: traced to the LN statistics, whose f32 mean and
  variance are summed in another order by XLA and by PyTorch (bit-equal in
  only a third of the rows); after the bf16 round trip 1 LN value in ~25,000
  differs by one bf16 ulp, which moves one int8 activation and, rarely, a
  Gumbel argmax. Measured 0-5 of 168 cells over 8 seeds; the bound is 4%.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import port_config, tiny_models  # noqa: E402

K, KP, NL, T = 1025, 1152, 7, 20


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("step", [0, 1, T // 2, T - 1])
def test_tail_scalars_bit_identical(step):
    from mars5_tts_tpu.diffusion.multinomial import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.ops.pallas.diffusion_tail import tail_scalars as j_scalars
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.kernels.diffusion_tail import tail_scalars

    jd = JDiff(K, timesteps=T)
    ref = np.asarray(j_scalars(jd, jnp.int32(step), jd.log_num_classes))
    np.testing.assert_array_equal(tail_scalars(MultinomialDiffusion(K, T), step).numpy(), ref)


@pytest.fixture(scope="module")
def folded_heads():
    """The JAX package's folded heads (class axis padded to the TPU's 1152
    for its kernel) of the tiny NAR with moved head LN affines."""
    from mars5_tts_tpu.models.nar import fold_quant_heads
    from mars5_tts_tpu.ops.quant import quantize_nar

    cfgs, params = tiny_models()
    p = jax.tree.map(jnp.asarray, params["nar"])
    r = np.random.default_rng(11)
    rd = dict(p["residual_decoder"])
    rd["ln_w"] = jnp.asarray(r.uniform(0.3, 1.8, rd["ln_w"].shape).astype(np.float32))
    rd["ln_b"] = jnp.asarray((r.standard_normal(rd["ln_b"].shape) * 0.2).astype(np.float32))
    rd["lin_b"] = jnp.asarray((r.standard_normal(rd["lin_b"].shape) * 0.1).astype(np.float32))
    p["residual_decoder"] = rd
    return cfgs["nar"], fold_quant_heads(quantize_nar(p), cfgs["nar"], tuple(range(1, 8)),
                                         pad_to=KP)


@pytest.mark.parametrize("w", [3.0, 1.0])
@pytest.mark.parametrize("step", [0, T // 2, T - 1])
def test_heads_tail_twin_matches_pallas(folded_heads, w, step):
    from mars5_tts_tpu.diffusion.multinomial import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.models.nar import nar_heads_prequant
    from mars5_tts_tpu.ops.pallas.diffusion_tail import heads_diffusion_tail, tail_scalars
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.kernels import diffusion_tail as P

    cfg, fj = folded_heads
    bs, L = 1, 64
    rows = 2 * bs if w != 1.0 else bs
    r = np.random.default_rng(step * 10 + int(w))
    out = jnp.asarray(r.standard_normal((rows, L, cfg.dim)).astype(np.float32) * 2,
                      jnp.bfloat16)
    x8, xs = nar_heads_prequant(out)
    u0 = r.random((bs, L, NL, K)).astype(np.float32)
    xt = r.integers(0, K, (bs, L, NL)).astype(np.int32)
    jd = JDiff(K, timesteps=T)
    u0p = np.pad(u0, ((0, 0), (0, 0), (0, 0), (0, KP - K))).reshape(bs, L, NL * KP)
    ref = heads_diffusion_tail(x8, xs, fj, jnp.asarray(u0p), jnp.asarray(xt),
                               tail_scalars(jd, jnp.int32(step), jd.log_num_classes),
                               n_classes=K, w=w, temp=0.7, bl=64, interpret=True)
    folded = {k: t(np.asarray(v)[:, :K]) for k, v in fj.items()}
    got = P.heads_diffusion_tail(t(np.asarray(x8)), t(np.asarray(xs)), folded, t(u0),
                                 t(xt), P.tail_scalars(MultinomialDiffusion(K, T), step),
                                 w=w, temp=0.7)
    assert got.dtype == torch.int64 and got.shape == (bs, L, NL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w", [3.0, 1.0])
@pytest.mark.parametrize("step", [0, T // 2])
def test_tail_twin_matches_pallas(w, step):
    """K5's twin against the JAX two-program chain's second program, on the
    same bf16 logits (padded to 1152 classes with -1e30 for the JAX kernel)."""
    from mars5_tts_tpu.diffusion.multinomial import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.ops.pallas.diffusion_tail import diffusion_tail, tail_scalars
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.kernels import diffusion_tail as P

    bs, L = 1, 64
    rows = 2 * bs if w != 1.0 else bs
    r = np.random.default_rng(step * 10 + int(w) + 100)
    logits = jnp.asarray(r.standard_normal((rows, L, NL, K)).astype(np.float32) * 3,
                         jnp.bfloat16)
    u0 = r.random((bs, L, NL, K)).astype(np.float32)
    xt = r.integers(0, K, (bs, L, NL)).astype(np.int32)
    jd = JDiff(K, timesteps=T)
    yp = jnp.pad(logits, ((0, 0), (0, 0), (0, 0), (0, KP - K)), constant_values=-1e30)
    u0p = np.pad(u0, ((0, 0), (0, 0), (0, 0), (0, KP - K))).reshape(bs, L, NL * KP)
    ref = diffusion_tail(yp.reshape(rows, L, NL * KP), jnp.asarray(u0p), jnp.asarray(xt),
                         tail_scalars(jd, jnp.int32(step), jd.log_num_classes),
                         n_classes=K, w=w, temp=0.7, bl=64, interpret=True)
    got = P.diffusion_tail(t(np.asarray(logits.astype(jnp.float32))).bfloat16(), t(u0), t(xt),
                           P.tail_scalars(MultinomialDiffusion(K, T), step), w=w, temp=0.7)
    assert got.dtype == torch.int64 and got.shape == (bs, L, NL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("step", [0, T - 1])
def test_tail_twin_on_folded_logits_equals_heads_twin(folded_heads, step):
    """The split chain (``nar_heads_folded`` -> K5 twin) and the K6 twin pick
    the same indices from the same decoder output and uniforms."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant
    from mars5_tts_torch.ops.kernels import diffusion_tail as P

    cfg, fj = folded_heads
    folded = {k: t(np.asarray(v)[:, :K]) for k, v in fj.items()}
    r = np.random.default_rng(step + 7)
    out = t(r.standard_normal((2, 48, cfg.dim)).astype(np.float32) * 2).bfloat16()
    u0 = t(r.random((1, 48, NL, K)).astype(np.float32))
    xt = t(r.integers(0, K, (1, 48, NL)))
    scal = P.tail_scalars(MultinomialDiffusion(K, T), step)
    x8, xs = nar_heads_prequant(out)
    want = P.heads_diffusion_tail(x8, xs, folded, u0, xt, scal, w=3.0, temp=0.7)
    logits = nar_heads_folded(folded, out)
    assert logits.dtype == torch.bfloat16
    got = P.diffusion_tail(logits, u0, xt, scal, w=3.0, temp=0.7)
    assert torch.equal(got, want)


def _batch(rng, gen=24, n_prompt=15, text_len=9):
    x = np.repeat(rng.integers(0, 1024, gen)[None, :, None], 8, axis=2)
    return (rng.integers(0, 258, (1, text_len)), rng.integers(0, 1024, (1, n_prompt, 8)),
            np.asarray([text_len]), np.asarray([n_prompt]), x, np.zeros((1, gen), bool))


def test_generator_path_split_route_equals_heads_route(monkeypatch):
    """bf16 W8A8 tiny NAR, seeded generator: the split route (folded heads,
    then K5, once per reverse step) gives the K6 route's grid."""
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion import engine
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.quant import quantize_nar
    from tests.torch_port_fixtures import port_nar

    cfgs, params = tiny_models()
    nar = quantize_nar(port_nar(cfgs["nar"], params["nar"]).to(torch.bfloat16))
    calls = {"diffusion_tail": [], "heads_diffusion_tail": []}
    for name, c in calls.items():
        fn = getattr(engine, name)
        monkeypatch.setattr(engine, name, lambda *a, _c=c, _f=fn, **k: _c.append(1) or _f(*a, **k))
    batch = _batch(np.random.default_rng(3))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=2)
    steps = 5
    grids = [engine.perform_simple_inference(
        nar, batch, MultinomialDiffusion(K, steps), steps, dsh,
        generator=torch.Generator().manual_seed(9), tail=route)
        for route in ("split", "heads")]
    assert len(calls["diffusion_tail"]) == len(calls["heads_diffusion_tail"]) == steps
    assert torch.equal(grids[0], grids[1])
    with pytest.raises(ValueError):
        engine.perform_simple_inference(nar, batch, MultinomialDiffusion(K, steps), steps, dsh,
                                        tail="fused")


def test_generator_path_k6_route_equals_dense_route(monkeypatch):
    """bf16 W8A8 tiny NAR, seeded generator: the K6 route (called once per
    reverse step) and the folded-heads dense route consume the same draws and
    give the same grid."""
    from mars5_tts_tpu.config import DSH
    from mars5_tts_torch.diffusion import engine
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.quant import quantize_nar
    from tests.torch_port_fixtures import port_nar

    cfgs, params = tiny_models()
    nar = quantize_nar(port_nar(cfgs["nar"], params["nar"]).to(torch.bfloat16))
    calls = []
    k6 = engine.heads_diffusion_tail
    monkeypatch.setattr(engine, "heads_diffusion_tail",
                        lambda *a, **k: calls.append(1) or k6(*a, **k))
    batch = _batch(np.random.default_rng(1))
    dsh = DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=2)
    steps = 6
    grids = [engine.perform_simple_inference(
        nar, batch, MultinomialDiffusion(K, steps), steps, dsh,
        generator=torch.Generator().manual_seed(5), tail=route)
        for route in ("heads", "dense")]
    assert len(calls) == steps
    assert grids[0].shape == (1, 24, 8)
    assert torch.equal(grids[0], grids[1])


def _pallas_gemms():
    """The JAX package's K3/K4 Pallas kernels (interpret mode) behind the
    port's ``fused_linear`` / ``fused_ffn`` signatures."""
    from mars5_tts_tpu.ops.pallas import nar_fused as JF

    def j(a):
        if a is None:
            return None
        return jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)

    def back(y, like):
        return torch.from_numpy(np.array(y.astype(jnp.float32))).to(like.dtype)

    def fused_linear(x, w, *, ln=None, bias=None, residual=None, eps=4e-5, groups=1):
        wd = {"q": jnp.asarray(w[0].numpy()), "s": jnp.asarray(w[1].numpy())}
        return back(JF.fused_linear(j(x), wd, ln=None if ln is None else (j(ln[0]), j(ln[1])),
                                    bias=j(bias), residual=j(residual), eps=eps, groups=groups,
                                    bm=64, interpret=True), x)

    def fused_ffn(x, ln, w, v, lin2, lin2_b, *, eps=4e-5, groups=1, groups2=None):
        wv = {"q": jnp.asarray(torch.cat([w[0], v[0]]).numpy()),
              "s": jnp.asarray(torch.cat([w[1], v[1]]).numpy())}
        l2 = {"q": jnp.asarray(lin2[0].numpy()), "s": jnp.asarray(lin2[1].numpy())}
        return back(JF.fused_ffn(j(x), j(ln[0]), j(ln[1]), wv, l2, j(lin2_b), eps=eps,
                                 groups=groups, groups2=groups2, bm=64, interpret=True), x)

    return fused_linear, fused_ffn


@pytest.fixture(scope="module")
def w8a8_trajectories():
    """Injected uniforms, T = 4, deep clone with CFG, the tiny f32 NAR under
    the JAX package's quantize_nar: the JAX grid (fused decoder kernels in
    interpret mode), and a function running the port's engine on the
    converted weights."""
    import os

    from mars5_tts_tpu.config import DSH
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfgs, params = tiny_models()
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, params["nar"])))
    pcfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    nar = load_nar(nar_reference_state_dict(pq, pcfg), pcfg)
    assert nar.is_quantized
    rng = np.random.default_rng(2)
    batch = _batch(rng, gen=21, n_prompt=13)
    steps = 4
    dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True,
              jump_len=1, jump_n_sample=1, q0_override_steps=2,
              enable_kevin_scaled_inference=True)
    n_steps = len(build_step_plan(steps)[0])
    uni = rng.random((n_steps, 2, 1, 13 + 21, 8, K)).astype(np.float32)
    x_init = rng.integers(0, K, (1, 21, 8))
    old = os.environ.get("MARS5_NAR_FUSED_INTERPRET")
    os.environ["MARS5_NAR_FUSED_INTERPRET"] = "1"
    try:
        want = np.asarray(j_infer(jax.tree.map(jnp.asarray, pq), cfgs["nar"], batch,
                                  JDiff(K, steps), steps, dsh, uniforms=uni, x_init=x_init))
    finally:
        if old is None:
            del os.environ["MARS5_NAR_FUSED_INTERPRET"]
        else:
            os.environ["MARS5_NAR_FUSED_INTERPRET"] = old

    def port():
        return perform_simple_inference(nar, batch, MultinomialDiffusion(K, steps), steps,
                                        dsh, uniforms=uni, x_init=x_init).numpy()
    return want, port


def test_w8a8_trajectory_identical_to_jax_on_its_gemm_kernels(w8a8_trajectories,
                                                             monkeypatch):
    from mars5_tts_torch.models import layers

    want, port = w8a8_trajectories
    fused_linear, fused_ffn = _pallas_gemms()
    monkeypatch.setattr(layers, "fused_linear", fused_linear)
    monkeypatch.setattr(layers, "fused_ffn", fused_ffn)
    np.testing.assert_array_equal(port(), want)


def test_w8a8_trajectory_matches_jax(w8a8_trajectories):
    want, port = w8a8_trajectories
    got = port()
    assert got.shape == want.shape == (1, 21, 8)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])   # L0: the AR codes
    assert (got != want).mean() <= 0.04
