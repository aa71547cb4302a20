"""The NAR and pipeline options of the port's serving surface against the
JAX package at tiny geometry:

* the guidance interval (cond-only steps outside ``[round(lo T),
  round(hi T))``): grids identical to the JAX engine's under injected
  uniforms, deep and shallow clone at one row and on a ragged two-row batch
  (two voices); (0, 1) op for op the run without an interval; an empty
  interval the w = 1 run;
* the geometry buckets: the real-frame grid identical to JAX's bucketed run
  and to the unbucketed one;
* ``honor_last_greedy``: the JAX ``_diffusion_scan(..., honor_last_greedy=True)``
  grid; on the generator path the K6, K5 and dense routes agree with it and
  with the interval;
* the K6 / K5 twins with ``rows == bs`` and ``scalars[5] = 0`` (the greedy
  last step) against the Pallas kernels in interpret mode;
* ``ar_generate_nocache`` tokens equal to JAX's; ``filter_topk_subset_rows``
  equal to JAX's;
* ``Mars5TTS`` with the deploy configuration (fused4 AR,
  ``guidance_interval=(0, 0.5)``, buckets 64 / 32) against the JAX pipeline
  on shared streams: AR codes identical, the bf16 NAR's grid identical, the
  int8 NAR's within the W8A8 bound, and identical on the JAX quantizer's
  weights with the JAX GEMM kernels; ``use_kv_cache=False``; the bucket
  defaults from the environment; ``from_pretrained`` through its local
  search.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import (fused_ar, make_tokenizers, port_codeclm,  # noqa: E402
                                       port_nar, tiny_models, write_checkpoints)

K, T = 1025, 10


def _case(rng, layout):
    """(batch, l_total) of a layout: "deep" / "shallow" one row, "ragged" two
    rows with their own prompt lengths (deep clone)."""
    lt, lx = 9, 12
    if layout == "ragged":
        lcs = [7, 4]
        codes = np.zeros((2, 7, 8), np.int64)
        for i, lc in enumerate(lcs):
            codes[i, :lc] = rng.integers(0, 1024, (lc, 8))
        xpm = np.zeros((2, lx), bool)
        xpm[1, 9:] = True
        x = np.repeat(rng.integers(0, 1024, (2, lx))[..., None], 8, axis=2)
        return (rng.integers(0, 259, (2, lt)), codes, np.asarray([lt, 6]), np.asarray(lcs),
                x, xpm), 7 + lx
    lc = 7
    x = np.repeat(rng.integers(0, 1024, lx)[None, :, None], 8, axis=2)
    batch = (rng.integers(0, 259, (1, lt)), rng.integers(0, 1024, (1, lc, 8)),
             np.asarray([lt]), np.asarray([lc]), x, np.zeros((1, lx), bool))
    return batch, lx + (lc if layout == "deep" else 0)


def _dsh(mod, layout, **kw):
    args = dict(last_greedy=True, x_0_temp=0.7, guidance_w=3.0,
                deep_clone=layout != "shallow", jump_len=1, jump_n_sample=1,
                q0_override_steps=3, enable_kevin_scaled_inference=True)
    args.update(kw)
    return mod.DSH(**args)


def _runs(layout, seed=0, jax_kw=None, **kw):
    """(JAX grid, port grid) of one injected-uniform trajectory of
    ``layout``; ``kw`` DSH fields and the port's keyword arguments."""
    import mars5_tts_tpu.config as JC
    import mars5_tts_torch.config as PC
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff

    cfgs, params = tiny_models()
    rng = np.random.default_rng(seed)
    batch, l_total = _case(rng, layout)
    bs = batch[0].shape[0]
    dsh_kw = {k: v for k, v in kw.items() if k in ("guidance_interval", "guidance_w")}
    eng_kw = {k: v for k, v in kw.items() if k not in dsh_kw}
    u = rng.random((T, 2, bs, l_total, 8, K)).astype(np.float32)
    x_init = rng.integers(0, K, batch[4].shape)
    ref = np.asarray(j_infer(params["nar"], cfgs["nar"], batch, JDiff(K, timesteps=T), T,
                             _dsh(JC, layout, **dsh_kw), uniforms=u, x_init=x_init,
                             **(jax_kw or {})))
    got = p_infer(port_nar(cfgs["nar"], params["nar"]), batch, PDiff(K, timesteps=T), T,
                  _dsh(PC, layout, **dsh_kw), uniforms=u, x_init=x_init, **eng_kw).numpy()
    return ref, got


@pytest.mark.parametrize("interval", [(0.0, 0.5), (0.3, 1.0)])
@pytest.mark.parametrize("layout", ["deep", "shallow", "ragged"])
def test_guidance_interval_grid_identical_to_jax(layout, interval):
    ref, got = _runs(layout, guidance_interval=interval)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_guidance_interval_endpoints():
    """(0, 1) is the run without an interval; an empty interval runs every
    step on the cond rows alone, the w = 1 trajectory."""
    base = _runs("deep", seed=4)[1]
    np.testing.assert_array_equal(_runs("deep", seed=4, guidance_interval=(0.0, 1.0))[1], base)
    np.testing.assert_array_equal(_runs("deep", seed=4, guidance_interval=(1.0, 1.0))[1],
                                  _runs("deep", seed=4, guidance_w=1.0)[1])


@pytest.mark.parametrize("layout", ["deep", "shallow", "ragged"])
def test_geometry_buckets_identical_to_jax_and_exact_shapes(layout):
    buckets = dict(gen_bucket=64, text_bucket=32)
    ref, got = _runs(layout, seed=2, jax_kw=buckets, guidance_interval=(0.0, 0.5), **buckets)
    exact = _runs(layout, seed=2, guidance_interval=(0.0, 0.5))[1]
    assert got.shape == ref.shape == exact.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("layout", ["deep", "ragged"])
def test_honor_last_greedy_matches_jax_scan(layout, monkeypatch):
    import mars5_tts_tpu.diffusion.engine as JE

    scan = JE._diffusion_scan
    monkeypatch.setattr(JE, "_diffusion_scan",
                        lambda *a, **k: scan(*a, honor_last_greedy=True, **k))
    ref, got = _runs(layout, seed=3, honor_last_greedy=True)
    np.testing.assert_array_equal(got, ref)
    sampled = _runs(layout, seed=3)[1]
    assert not np.array_equal(got, sampled)       # t = 0 took the argmax


def test_generator_routes_agree_with_interval_and_greedy_step():
    """W8A8 tiny NAR, seeded generator, interval (0, 0.5), greedy t = 0: the
    K6 route, the split route (K5) and the dense route draw the same
    uniforms and give one grid; the greedy last step moves it."""
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.quant import quantize_nar

    cfgs, params = tiny_models()
    nar = quantize_nar(port_nar(cfgs["nar"], params["nar"]).to(torch.bfloat16))
    batch, _ = _case(np.random.default_rng(6), "deep")
    dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True,
              q0_override_steps=2, guidance_interval=(0.0, 0.5))
    steps = 6

    def run(tail, greedy=True):
        return perform_simple_inference(nar, batch, MultinomialDiffusion(K, steps), steps, dsh,
                                        generator=torch.Generator().manual_seed(5), tail=tail,
                                        honor_last_greedy=greedy)
    grids = [run(tail) for tail in ("heads", "split", "dense")]
    assert torch.equal(grids[0], grids[1]) and torch.equal(grids[0], grids[2])
    assert not torch.equal(grids[0], run("heads", greedy=False))


def test_progress_prints_every_ten_steps(capsys):
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion

    cfgs, params = tiny_models()
    batch, _ = _case(np.random.default_rng(1), "deep")
    steps = 12
    perform_simple_inference(port_nar(cfgs["nar"], params["nar"]), batch,
                             MultinomialDiffusion(K, steps), steps,
                             DSH(guidance_w=3.0, deep_clone=True, progress=True),
                             generator=torch.Generator().manual_seed(1))
    assert capsys.readouterr().err == "\rdiffusion step 10/12\rdiffusion step 12/12\n"


# ------------------------------------------------- the tails' greedy last step

@pytest.fixture(scope="module")
def folded_heads():
    from tests.test_torch_diffusion_tail import KP

    from mars5_tts_tpu.models.nar import fold_quant_heads
    from mars5_tts_tpu.ops.quant import quantize_nar

    cfgs, params = tiny_models()
    p = jax.tree.map(jnp.asarray, params["nar"])
    return cfgs["nar"], fold_quant_heads(quantize_nar(p), cfgs["nar"], tuple(range(1, 8)),
                                         pad_to=KP)


@pytest.mark.parametrize("cfg_rows", [False, True])
@pytest.mark.parametrize("step", [0, T // 2])
def test_tail_twins_greedy_match_pallas(folded_heads, cfg_rows, step):
    """``tail_scalars(use_gumbel=False)`` (scalars[5] = 0), at rows == bs (a
    cond-only step, w forced to 1) and rows == 2 bs: the K6 twin and the K5
    twin pick the JAX kernels' indices (interpret mode)."""
    from tests.test_torch_diffusion_tail import KP, NL, t

    from mars5_tts_tpu.diffusion.multinomial import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.models.nar import nar_heads_folded as j_heads_folded
    from mars5_tts_tpu.models.nar import nar_heads_prequant
    from mars5_tts_tpu.ops.pallas import diffusion_tail as JT
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.kernels import diffusion_tail as P

    cfg, fj = folded_heads
    bs, L = 2, 64
    rows = 2 * bs if cfg_rows else bs
    r = np.random.default_rng(step + 31 * cfg_rows)
    out = jnp.asarray(r.standard_normal((rows, L, cfg.dim)).astype(np.float32) * 2, jnp.bfloat16)
    x8, xs = nar_heads_prequant(out)
    u0 = r.random((bs, L, NL, K)).astype(np.float32)
    xt = r.integers(0, K, (bs, L, NL)).astype(np.int32)
    jd = JDiff(K, timesteps=T)
    scal_j = JT.tail_scalars(jd, jnp.int32(step), jd.log_num_classes).at[5].set(0.0)
    scal = P.tail_scalars(MultinomialDiffusion(K, T), step, use_gumbel=False)
    np.testing.assert_array_equal(scal.numpy(), np.asarray(scal_j))
    u0p = jnp.asarray(np.pad(u0, ((0, 0), (0, 0), (0, 0), (0, KP - K))).reshape(bs, L, NL * KP))
    ref = np.asarray(JT.heads_diffusion_tail(x8, xs, fj, u0p, jnp.asarray(xt), scal_j,
                                             n_classes=K, w=3.0, temp=0.7, bl=64,
                                             interpret=True))
    folded = {k: t(np.asarray(v)[:, :K]) for k, v in fj.items()}
    got = P.heads_diffusion_tail(t(np.asarray(x8)), t(np.asarray(xs)), folded, t(u0), t(xt),
                                 scal, w=3.0, temp=0.7)
    np.testing.assert_array_equal(got.numpy(), ref)
    # K5 on the same folded heads' bf16 logits
    y = j_heads_folded(fj, out, flat=True)
    ref5 = np.asarray(JT.diffusion_tail(y, u0p, jnp.asarray(xt), scal_j, n_classes=K, w=3.0,
                                        temp=0.7, bl=64, interpret=True))
    logits = t(np.asarray(y.astype(jnp.float32))).reshape(rows, L, NL, KP)[..., :K].bfloat16()
    got5 = P.diffusion_tail(logits, t(u0), t(xt), scal, w=3.0, temp=0.7)
    np.testing.assert_array_equal(got5.numpy(), ref5)
    # the greedy draw is the argmax of the posterior alone: the uniforms do not count
    again = P.heads_diffusion_tail(t(np.asarray(x8)), t(np.asarray(xs)), folded,
                                   t(np.random.default_rng(0).random(u0.shape).astype(np.float32)),
                                   t(xt), scal, w=3.0, temp=0.7)
    assert torch.equal(again, got)


# ---------------------------------------------------------------- the AR

@pytest.mark.parametrize("top_k,top_p,typical_p", [(200, 0.2, 1.0), (50, 0.9, 0.7),
                                                   (0, 0.8, 1.0)])
def test_ar_generate_nocache_tokens_equal_jax(top_k, top_p, typical_p):
    from mars5_tts_tpu.models import ar_decode as J
    from mars5_tts_torch.models import ar_decode as P

    cfgs, params = tiny_models()
    model = port_codeclm(cfgs["ar"], params["ar"])
    r = np.random.default_rng(top_k + 1)
    spk = r.integers(0, 1024, (20, 8))
    prompt = np.concatenate([r.integers(0, 258, 8), spk[:, 0] + 258])
    vs, ve = J.ar_vocab_window(258, 1025, cfgs["ar"].n_vocab)
    common = dict(temperature=0.7, top_k=top_k, top_p=top_p, typical_p=typical_p,
                  alpha_frequency=3.0, alpha_presence=0.4, penalty_window=8,
                  n_phones_gen=12, eos_idx=258 + 1024, valid_start=vs, valid_end=ve,
                  max_len=len(prompt) + 24)
    u = np.random.default_rng(8).random(common["max_len"]).astype(np.float32)
    ref, n_ref = J.ar_generate_nocache(params["ar"], cfgs["ar"], prompt, spk,
                                       sampling=J.ArSampling(**common), uniforms=u)
    got, n_got = P.ar_generate_nocache(model, prompt, spk, sampling=P.ArSampling(**common),
                                       uniforms=u)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert n_got == n_ref > 8


def test_filter_topk_subset_rows_matches_jax():
    """Per-row k, top-p and typical mass (rows with the filters off
    included) equal to JAX's, and rows at the static values equal to the
    static filter."""
    from mars5_tts_tpu.ops import sampling as J
    from mars5_tts_torch.ops import sampling as P

    r = np.random.default_rng(0)
    logits = (r.standard_normal((5, 300)) * 3).astype(np.float32)
    logits[3, 100:] = -np.inf
    k_row = np.asarray([20, 7, 20, 1, 12], np.int32)
    top_p = np.asarray([0.9, 1.0, 0.3, 0.5, 1.0], np.float32)
    typical = np.asarray([1.0, 0.6, 0.8, 1.0, 0.95], np.float32)
    ref = np.asarray(J.filter_topk_subset_rows(jnp.asarray(logits), 20, jnp.asarray(k_row),
                                               jnp.asarray(top_p), jnp.asarray(typical)))
    got = P.filter_topk_subset_rows(torch.from_numpy(logits), 20, torch.from_numpy(k_row).long(),
                                    torch.from_numpy(top_p), torch.from_numpy(typical))
    np.testing.assert_array_equal(got.numpy(), ref)
    static = P.filter_topk_subset(torch.from_numpy(logits[:1]), 20, 0.9, 1.0)
    np.testing.assert_array_equal(got[:1].numpy(), static.numpy())


@pytest.mark.parametrize("skip", ["k", "top_p", "typical", "all"])
def test_filter_topk_subset_rows_skips_blocks_no_row_needs(skip):
    """A block passed as None (no row needs it, as ``filter_logits`` finds
    from its host values) gives what the block gives with every row's value
    at its off setting."""
    from mars5_tts_torch.ops import sampling as P

    r = np.random.default_rng(1)
    logits = torch.from_numpy((r.standard_normal((4, 300)) * 3).astype(np.float32))
    vals = {"k": torch.tensor([20, 7, 20, 3]), "top_p": torch.tensor([0.9, 1.0, 0.3, 0.5]),
            "typical": torch.tensor([1.0, 0.6, 0.8, 0.95])}
    off = {"k": torch.full((4,), 20), "top_p": torch.ones(4), "typical": torch.ones(4)}
    names = list(vals) if skip == "all" else [skip]
    full = P.filter_topk_subset_rows(logits, 20, *[off[n] if n in names else vals[n]
                                                   for n in vals])
    got = P.filter_topk_subset_rows(logits, 20, *[None if n in names else vals[n]
                                                  for n in vals])
    assert torch.equal(got, full)


# ---------------------------------------------------------- the pipeline

def _ar_uniforms(fn, u):
    def run(*a, sampling, seed=0, **k):
        return fn(*a, sampling=sampling, uniforms=u[:sampling.max_len], **k)
    return run


def _nar_draws(fn, grids, name, drop, steps):
    def run(*a, **k):
        batch = a[2] if name == "jax" else a[1]
        lc = np.shape(batch[1])[1] if k.get("dsh", a[5 if name == "jax" else 4]).deep_clone else 0
        rng = np.random.default_rng(lc * 1000 + np.shape(batch[4])[1])
        uni = rng.random((steps, 2, 1, lc + np.shape(batch[4])[1], 8, K)).astype(np.float32)
        x_init = rng.integers(0, K, np.shape(batch[4]))
        for key in drop:
            k.pop(key, None)
        grids[name] = np.asarray(fn(*a, uniforms=uni, x_init=x_init, **k))
        return grids[name]
    return run


def _deploy_pipelines(monkeypatch, nar_backend):
    """``deploy/predict.py``'s defaults (fused4 AR, ``guidance_interval=(0,
    0.5)``, buckets 64 / 32) through both pipelines on shared AR uniforms
    and NAR draws, each package quantizing its own int8 NAR. Returns (the
    port's and the JAX pipeline's (codes, audio), {"port", "jax"} grids)."""
    import mars5_tts_tpu.models.ar_decode_fused as JF
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig

    monkeypatch.setenv("MARS5_FUSED_INTERPRET", "emu")
    monkeypatch.setenv("MARS5_NAR_FUSED_INTERPRET", "1")
    steps = 4
    u_ar = np.random.default_rng(9).random(4096).astype(np.float32)
    grids = {}
    monkeypatch.setattr(JF, "ar_generate_fused", _ar_uniforms(JF.ar_generate_fused, u_ar))
    monkeypatch.setattr(PP, "ar_generate_fused", _ar_uniforms(PP.ar_generate_fused, u_ar))
    monkeypatch.setattr(JP, "perform_simple_inference",
                        _nar_draws(JP.perform_simple_inference, grids, "jax", ("key",), steps))
    monkeypatch.setattr(PP, "perform_simple_inference",
                        _nar_draws(PP.perform_simple_inference, grids, "port", ("generator",),
                                   steps))
    deploy = dict(guidance_interval=(0.0, 0.5), nar_gen_bucket=64, nar_text_bucket=32,
                  ar_backend="fused4", nar_backend=nar_backend)
    cfg, params = fused_ar()
    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(params, tiny["nar"], cfg, cfgs["nar"], texttok=texttok,
                                   speechtok=speechtok, encodec_params=tiny["encodec"],
                                   vocos_params=tiny["vocos"], encodec_cfg=cfgs["encodec"],
                                   vocos_cfg=cfgs["vocos"], **deploy)
    ptts = _port_tts(ar=(cfg, params), **deploy)
    assert (ptts.guidance_interval, ptts.nar_gen_bucket, ptts.nar_text_bucket) == (
        (0.0, 0.5), 64, 32)
    ref = (np.random.default_rng(4).standard_normal(8 * 60) * 0.1).astype(np.float32)
    icfg = InferenceConfig(timesteps=steps, generate_max_len_override=100, trim_db=200)
    outs = {name: tts.tts("hi there", ref, ref_transcript="ok", cfg=icfg, seed=3)
            for name, tts in (("jax", jtts), ("port", ptts))}
    return outs, grids


@pytest.mark.parametrize("nar_backend", ["bf16", "int8"])
def test_deploy_configuration_matches_jax_pipeline(monkeypatch, nar_backend):
    """``deploy/predict.py``'s defaults through both pipelines (fused4 AR,
    ``guidance_interval=(0, 0.5)``, buckets 64 / 32) on shared AR uniforms
    and NAR draws: identical AR codes; with the bf16 NAR an identical grid,
    with the int8 NAR (each package quantizing its own) the W8A8 NAR's bound
    of ``tests/test_torch_diffusion_tail.py`` (identity with the JAX GEMM
    kernels and attention swapped in is the test after next)."""
    outs, grids = _deploy_pipelines(monkeypatch, nar_backend)
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert len(outs["port"][0]) > 0 and np.isfinite(outs["port"][1]).all()
    assert grids["port"].shape == grids["jax"].shape
    if nar_backend == "bf16":
        np.testing.assert_array_equal(grids["port"], grids["jax"])
    else:
        np.testing.assert_array_equal(grids["port"][..., 0], grids["jax"][..., 0])
        assert (grids["port"] != grids["jax"]).mean() <= 0.04


def test_w8a8_deploy_pipeline_identical_to_jax_with_its_gemms_and_attention(monkeypatch):
    """The int8 deploy pipeline's few differing grid cells (the test above)
    are the f32 attention's sums taken in PyTorch's order: with the JAX GEMM
    kernels (K3/K4, interpret mode) swapped into the port, the pipelines
    still part in a few cells (the quantized weights, the reference codes,
    the bucketed batch and masks each bitwise JAX's), because the
    attention's f32 sums (``mha_ref`` against ``sdpa_pallas``, ``sdpa``'s
    einsums against XLA's dots) round in the last ulp, and the W8A8
    activation quant of the next site turns that into another int8 value
    now and then. Given JAX's attention as well (``sdpa_pallas`` in
    interpret mode for K1's twin, the JAX ``sdpa`` for the plain one), the
    grid is JAX's, cell for cell."""
    import mars5_tts_tpu.ops.attention as JA
    from mars5_tts_tpu.ops.pallas.mha import sdpa_pallas
    import mars5_tts_torch.ops.attention as PA
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.ops.kernels import mha as PM
    from tests.test_torch_diffusion_tail import _pallas_gemms

    def j(t):
        return None if t is None else jnp.asarray(t.detach().numpy())

    def back(y, like):
        return torch.from_numpy(np.array(y)).to(like.dtype)

    def jax_mha(q, k, v, key_padding_mask=None, quantized=False):
        assert not quantized
        return back(sdpa_pallas(j(q), j(k), j(v), j(key_padding_mask), interpret=True), q)

    def jax_sdpa(q, k, v, mask=None, scores_bf16=True):
        assert scores_bf16      # the deploy default: JAX reads MARS5_SDPA_BF16 unset, "1"
        return back(JA.sdpa(j(q), j(k), j(v), j(mask)), q)

    fused_linear, fused_ffn = _pallas_gemms()
    monkeypatch.setattr(layers, "fused_linear", fused_linear)
    monkeypatch.setattr(layers, "fused_ffn", fused_ffn)
    monkeypatch.setattr(PM, "mha", jax_mha)
    monkeypatch.setattr(PA, "sdpa", jax_sdpa)
    monkeypatch.setattr(layers, "sdpa", jax_sdpa)
    outs, grids = _deploy_pipelines(monkeypatch, "int8")
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    np.testing.assert_array_equal(grids["port"], grids["jax"])


def test_w8a8_deploy_options_identical_to_jax_on_its_gemm_kernels(monkeypatch):
    """The JAX ``quantize_nar`` weights carried across, interval (0, 0.5) and
    buckets 64 / 32 under injected uniforms: with the port's K3/K4 twins
    swapped for the JAX Pallas kernels (interpret mode) the W8A8 grid is the
    JAX engine's, cell for cell."""
    import mars5_tts_tpu.config as JC
    import mars5_tts_torch.config as PC
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models import layers
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig
    from tests.test_torch_diffusion_tail import _pallas_gemms
    from tests.torch_port_fixtures import port_config

    monkeypatch.setenv("MARS5_NAR_FUSED_INTERPRET", "1")
    cfgs, params = tiny_models()
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, params["nar"])))
    pcfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    nar = load_nar(nar_reference_state_dict(pq, pcfg), pcfg)
    fused_linear, fused_ffn = _pallas_gemms()
    monkeypatch.setattr(layers, "fused_linear", fused_linear)
    monkeypatch.setattr(layers, "fused_ffn", fused_ffn)
    rng = np.random.default_rng(2)
    batch, l_total = _case(rng, "deep")
    steps = 4
    uni = rng.random((steps, 2, 1, l_total, 8, K)).astype(np.float32)
    x_init = rng.integers(0, K, batch[4].shape)
    opts = dict(uniforms=uni, x_init=x_init, gen_bucket=64, text_bucket=32)
    want = np.asarray(j_infer(jax.tree.map(jnp.asarray, pq), cfgs["nar"], batch,
                              JDiff(K, steps), steps,
                              _dsh(JC, "deep", guidance_interval=(0.0, 0.5)), **opts))
    got = perform_simple_inference(nar, batch, MultinomialDiffusion(K, steps), steps,
                                   _dsh(PC, "deep", guidance_interval=(0.0, 0.5)), **opts)
    np.testing.assert_array_equal(got.numpy(), want)


def _port_tts(ar=None, **kw):
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree

    cfgs, tiny = tiny_models()
    cfg, params = ar or (cfgs["ar"], tiny["ar"])
    texttok, speechtok, _, _ = make_tokenizers()
    return Mars5TTS.from_params(port_codeclm(cfg, params), port_nar(cfgs["nar"], tiny["nar"]),
                                texttok=texttok, speechtok=speechtok,
                                encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), **kw)


@pytest.mark.parametrize("ar_backend", ["bf16", "fused4"])
def test_tts_without_kv_cache_runs_the_nocache_engine(monkeypatch, ar_backend):
    """``use_kv_cache=False``: ``tts`` decodes with ``ar_generate_nocache`` on
    the model as loaded, whatever ``ar_backend``, and gives the tokens of the
    JAX pipeline's nocache route on shared uniforms."""
    import mars5_tts_tpu.models.ar_decode as JA
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig

    u = np.random.default_rng(2).random(4096).astype(np.float32)
    calls = []
    nocache = _ar_uniforms(PP.ar_generate_nocache, u)
    monkeypatch.setattr(PP, "ar_generate_nocache",
                        lambda *a, **k: calls.append(1) or nocache(*a, **k))
    monkeypatch.setattr(JP, "ar_generate_nocache", _ar_uniforms(JA.ar_generate_nocache, u))
    for name in ("ar_generate", "ar_generate_fused"):
        monkeypatch.setattr(PP, name, lambda *a, **k: pytest.fail("a cached AR engine ran"))
    cfg, params = fused_ar()
    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(params, tiny["nar"], cfg, cfgs["nar"], texttok=texttok,
                                   speechtok=speechtok, encodec_params=tiny["encodec"],
                                   vocos_params=tiny["vocos"], encodec_cfg=cfgs["encodec"],
                                   vocos_cfg=cfgs["vocos"])
    ptts = _port_tts(ar=(cfg, params), ar_backend=ar_backend)
    ref = (np.random.default_rng(6).standard_normal(8 * 40) * 0.1).astype(np.float32)
    icfg = InferenceConfig(timesteps=2, generate_max_len_override=70, use_kv_cache=False)
    want = jtts.tts("yo", ref, ref_transcript="a", cfg=icfg, seed=1)[0]
    got, audio = ptts.tts("yo", ref, ref_transcript="a", cfg=icfg, seed=1)
    assert calls == [1]
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(audio).all()


def test_bucket_defaults_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("MARS5_NAR_GEN_BUCKET", "48")
    monkeypatch.setenv("MARS5_NAR_TEXT_BUCKET", "16")
    tts = _port_tts()
    assert (tts.nar_gen_bucket, tts.nar_text_bucket, tts.guidance_interval) == (48, 16,
                                                                                 (0.0, 1.0))
    tts = _port_tts(nar_gen_bucket=0, nar_text_bucket=8)
    assert (tts.nar_gen_bucket, tts.nar_text_bucket) == (0, 8)
    monkeypatch.delenv("MARS5_NAR_GEN_BUCKET")
    monkeypatch.delenv("MARS5_NAR_TEXT_BUCKET")
    assert (_port_tts().nar_gen_bucket, _port_tts().nar_text_bucket) == (0, 0)


def test_from_pretrained_searches_the_local_caches(tmp_path, monkeypatch):
    """Without ``huggingface_hub`` the checkpoints are found under
    ``cache_dir``, ``MARS5_CACHE`` or ``HF_HOME`` (files this test writes;
    nothing is downloaded), else FileNotFoundError."""
    import sys

    from mars5_tts_torch import Mars5TTS

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)   # the import fails
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("MARS5_CACHE", str(empty))
    monkeypatch.setenv("HF_HOME", str(empty))
    with pytest.raises(FileNotFoundError):
        Mars5TTS.from_pretrained(device="cpu")
    snap = tmp_path / "hub" / "models--x" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    write_checkpoints(snap)
    cfgs, params = tiny_models()
    for kw in ({"cache_dir": str(tmp_path / "hub")}, {}):
        if not kw:
            monkeypatch.setenv("HF_HOME", str(tmp_path / "hub"))
        tts = Mars5TTS.from_pretrained(device="cpu", nar_gen_bucket=16, **kw)
        assert tts.nar_gen_bucket == 16 and tts.ar_cfg.dim == cfgs["ar"].dim
