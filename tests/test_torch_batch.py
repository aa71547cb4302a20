"""The batched synthesis path of the port, ``Mars5TTS.tts_batch``, against
the JAX package at tiny geometry:

* the bf16 batched AR engine (``ar_generate_batched``, kernel K7's twin on
  the CPU): three rows with their own prompt and speaker lengths and
  early-EOS estimates, one ending at EOS early, token-identical to the JAX
  engine under one (max_len, 3) uniform stream, and each row to the port's
  own one-row run;
* the ragged deep-clone NAR (rows with different reference lengths): the
  grid identical to the JAX engine's under injected uniforms and each row to
  its solo run; the W8A8 NAR within the 4%-of-cells bound of
  ``tests/test_torch_diffusion_tail.py``;
* ``Mars5TTS.tts_batch`` of both packages on shared AR and NAR streams
  (Encodec -> batched AR -> ragged or static NAR -> batched Vocos): AR codes
  and grids identical, audio within ``AUDIO_ATOL``;
* the API: seeded determinism, the JAX package's errors for mismatched
  lists and its routing between the batched engines.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import (fused_ar, make_tokenizers, port_codeclm,  # noqa: E402
                                       port_config, port_nar, tiny_models)

AUDIO_ATOL = 1e-4      # tests/test_torch_pipeline.py
K = 1025


# ------------------------------------------------------------ the bf16 AR

@functools.lru_cache(maxsize=None)
def tiny_ar():
    """The JAX batched tests' AR (tests/test_ar_batched.py): config, params
    and the port's CodecLM."""
    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm

    cfg = CodecLMConfig.tiny(n_vocab=50)
    params = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(0), cfg))
    return cfg, params, port_codeclm(cfg, params)


def _sampling(mod, max_len, n_phones_gen=8):
    return mod.ArSampling(temperature=0.7, top_k=10, top_p=0.9, typical_p=1.0,
                          alpha_frequency=1.0, alpha_presence=0.4, penalty_window=5,
                          eos_penalty_decay=0.5, eos_penalty_factor=1.0,
                          n_phones_gen=n_phones_gen, eos_idx=49, valid_start=20,
                          valid_end=51, max_len=max_len)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_bf16_ar_matches_jax_and_solo_runs(seed):
    from mars5_tts_tpu.models import ar_decode as JA
    from mars5_tts_torch.models import ar_decode as PA

    cfg, params, model = tiny_ar()
    rng = np.random.default_rng(seed)
    max_len = 48
    prompts = [rng.integers(0, 20, n) for n in (6, 21, 9)]        # 15 apart
    spks = [rng.integers(0, 1024, (n, 8)) for n in (4, 17, 5)]
    u = rng.random((max_len, 3)).astype(np.float32)
    est = [2, 12, 30]
    want = JA.ar_generate_batched(jax.tree.map(jnp.asarray, params), cfg, prompts, spks,
                                  sampling=_sampling(JA, max_len), uniforms=u,
                                  est_lens=np.asarray(est))
    got = PA.ar_generate_batched(model, prompts, spks, sampling=_sampling(PA, max_len),
                                 uniforms=u, est_lens=est)
    for i, ((tg, ng), (tw, nw)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(tg, tw, err_msg=f"row {i}")
        assert ng == nw == len(tg) - len(prompts[i])
        solo = PA.ar_generate(model, prompts[i], spks[i], uniforms=u[:, i],
                              sampling=_sampling(PA, max_len, est[i]))
        np.testing.assert_array_equal(solo[0], tg, err_msg=f"row {i} solo")
    lens = [len(t) for t, _ in got]
    assert min(lens) < max_len, "no row ended at EOS"
    assert min(lens) < max(lens), "no row decoded on after another was done"


# -------------------------------------------------------------- the ragged NAR

def _dsh():
    from mars5_tts_tpu.config import DSH
    return DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True, jump_len=1,
               jump_n_sample=1, q0_override_steps=2, enable_kevin_scaled_inference=True)


def _ragged_case(seed=7, steps=5):
    """The JAX mixed-voice test's geometry (tests/test_nar_waves.py): two rows
    with prompt lengths 4 and 2 and 5 and 7 generated frames; each row's
    (n, 2, 1, L, 8, K) stream, solo batches and the ragged batch."""
    from mars5_tts_tpu.diffusion.schedule import build_step_plan

    lcs, lgs, lt = [4, 2], [5, 7], 6
    lx = max(lgs)
    rng = np.random.default_rng(seed)
    n = len(build_step_plan(steps)[0])
    c_texts = [rng.integers(0, 32, lt), rng.integers(0, 32, lt - 1)]
    c_codes = [rng.integers(0, 1024, (lc, 8)) for lc in lcs]
    l0 = [rng.integers(0, 1024, lg) for lg in lgs]
    L = max(lcs) + lx
    u_rows = [rng.random((n, 2, 1, L, 8, K)).astype(np.float32) for _ in lcs]
    x_init_rows = [rng.integers(0, K, (1, lx, 8)) for _ in lcs]
    solo = []
    for j, (lc, lg) in enumerate(zip(lcs, lgs)):
        batch = (c_texts[j][None], c_codes[j][None], [len(c_texts[j])], [lc],
                 np.repeat(l0[j][:, None], 8, axis=1)[None], np.zeros((1, lg), bool))
        solo.append((batch, u_rows[j][:, :, :, : lc + lg], x_init_rows[j][:, :lg]))
    c_text = np.zeros((2, lt), np.int64)
    codes = np.zeros((2, max(lcs), 8), np.int64)
    x = np.zeros((2, lx, 8), np.int64)
    xpm = np.ones((2, lx), bool)
    for j, (lc, lg) in enumerate(zip(lcs, lgs)):
        c_text[j, : len(c_texts[j])] = c_texts[j]
        codes[j, :lc] = c_codes[j]
        x[j, :lg] = np.repeat(l0[j][:, None], 8, axis=1)
        xpm[j, :lg] = False
    batch = (c_text, codes, np.asarray([len(c) for c in c_texts]), np.asarray(lcs), x, xpm)
    return (batch, np.concatenate(u_rows, axis=2), np.concatenate(x_init_rows)), solo, lgs


def test_ragged_nar_matches_jax_and_solo_runs():
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff

    cfgs, params = tiny_models()
    nar = port_nar(cfgs["nar"], params["nar"])
    T = 5
    (batch, u, x_init), solo, lgs = _ragged_case(steps=T)
    want = np.asarray(j_infer(params["nar"], cfgs["nar"], batch, JDiff(K, T), T, _dsh(),
                              uniforms=u, x_init=x_init))
    got = p_infer(nar, batch, PDiff(K, T), T, _dsh(), uniforms=u, x_init=x_init).numpy()
    assert got.shape == want.shape == (2, 7, 8)
    np.testing.assert_array_equal(got, want)
    for j, (b, uj, xj) in enumerate(solo):
        one = p_infer(nar, b, PDiff(K, T), T, _dsh(), uniforms=uj, x_init=xj).numpy()
        np.testing.assert_array_equal(got[j, : lgs[j]], one[0], err_msg=f"row {j}")


def test_ragged_w8a8_nar_within_bound_of_jax(monkeypatch):
    """The W8A8 NAR (JAX ``quantize_nar``, its fused GEMM kernels in
    interpret mode) on the ragged batch: L0 identical, other cells within
    the W8A8 route's 4% (LN sum order, ROADMAP C)."""
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    monkeypatch.setenv("MARS5_NAR_FUSED_INTERPRET", "1")
    cfgs, params = tiny_models()
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, params["nar"])))
    pcfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    nar = load_nar(nar_reference_state_dict(pq, pcfg), pcfg)
    T = 4
    (batch, u, x_init), _, _ = _ragged_case(seed=3, steps=T)
    want = np.asarray(j_infer(jax.tree.map(jnp.asarray, pq), cfgs["nar"], batch, JDiff(K, T),
                              T, _dsh(), uniforms=u, x_init=x_init))
    got = p_infer(nar, batch, PDiff(K, T), T, _dsh(), uniforms=u, x_init=x_init).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (got != want).mean() <= 0.04


def test_ragged_nar_generator_path_is_seeded():
    """The generator path (K6's twin on a W8A8 model, the known draws over
    the whole grid): reproducible from the seed, codes in [0, 1024], L0 the
    AR codes."""
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff
    from mars5_tts_torch.ops.quant import quantize_nar

    cfgs, params = tiny_models()
    nar = quantize_nar(port_nar(cfgs["nar"], params["nar"]))
    (batch, _, _), _, lgs = _ragged_case(steps=3)
    runs = [p_infer(nar, batch, PDiff(K, 3), 3, _dsh(),
                    generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) <= 1024
    for j, lg in enumerate(lgs):
        np.testing.assert_array_equal(runs[0][j, :lg, 0].numpy(), batch[4][j, :lg, 0])


# ------------------------------------------------------------ tts_batch

def _refs(*lengths):
    return [(np.random.default_rng(10 + n).standard_normal(n) * 0.1).astype(np.float32)
            for n in lengths]


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


@pytest.mark.parametrize("per_row", [True, False])
def test_tts_batch_matches_jax_pipeline(monkeypatch, per_row):
    """Both packages' ``tts_batch`` with the bf16 backends on shared AR and
    NAR streams: per-row voices of 7 and 5 frames (the ragged NAR) or one
    shared voice (the static one)."""
    import mars5_tts_tpu.models.ar_decode as JA
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig
    from mars5_tts_tpu.diffusion.schedule import build_step_plan

    steps = 4
    u_ar = np.random.default_rng(9).random((4096, 3)).astype(np.float32)
    grids, ars = {}, {}

    def ar_with_uniforms(fn, name):
        def run(*a, sampling, seed=0, **k):
            ars[name] = fn(*a, sampling=sampling, uniforms=u_ar[:sampling.max_len, :3], **k)
            return ars[name]
        return run

    def nar_with_draws(fn, name, drop):
        def run(*a, **k):
            c_codes, x = (a[2] if name == "jax" else a[1])[1::3]
            rng = np.random.default_rng(c_codes.shape[1] * 100 + x.shape[1])
            n = len(build_step_plan(steps)[0])
            u = rng.random((n, 2, x.shape[0], c_codes.shape[1] + x.shape[1], 8, K))
            for key in drop:
                k.pop(key, None)
            out = fn(*a, uniforms=u.astype(np.float32), x_init=rng.integers(0, K, x.shape), **k)
            grids[name] = np.asarray(out)
            return out
        return run

    monkeypatch.setattr(JA, "ar_generate_batched",
                        ar_with_uniforms(JA.ar_generate_batched, "jax"))
    monkeypatch.setattr(PP, "ar_generate_batched",
                        ar_with_uniforms(PP.ar_generate_batched, "port"))
    monkeypatch.setattr(JP, "perform_simple_inference",
                        nar_with_draws(JP.perform_simple_inference, "jax",
                                       ("key", "gen_bucket", "text_bucket")))
    monkeypatch.setattr(PP, "perform_simple_inference",
                        nar_with_draws(PP.perform_simple_inference, "port", ("generator",)))

    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(tiny["ar"], tiny["nar"], cfgs["ar"], cfgs["nar"],
                                   texttok=texttok, speechtok=speechtok,
                                   encodec_params=tiny["encodec"], vocos_params=tiny["vocos"],
                                   encodec_cfg=cfgs["encodec"], vocos_cfg=cfgs["vocos"])
    ptts = _port_tts()
    texts = ["hi there", "a longer line of text", "yo"]
    refs = _refs(8 * 56, 8 * 40, 8 * 48) if per_row else _refs(8 * 56)[0]
    trs = ["ok", "fine", "sure"] if per_row else "ok"
    icfg = InferenceConfig(timesteps=steps, generate_max_len_override=120, trim_db=200)
    outs = {name: tts.tts_batch(texts, refs, ref_transcript=trs, cfg=icfg, seed=3)
            for name, tts in (("jax", jtts), ("port", ptts))}
    for (tj, _), (tp, _) in zip(ars["jax"], ars["port"]):
        np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(grids["port"], grids["jax"])
    assert len(outs["port"]) == 3
    for (cj, wj), (cp, wp) in zip(outs["jax"], outs["port"]):
        np.testing.assert_array_equal(cp, cj)
        assert len(cp) > 0 and wp.dtype == np.float32 and wp.shape == np.shape(wj)
        np.testing.assert_allclose(wp, wj, atol=AUDIO_ATOL)
    timing = ptts.last_timing
    assert timing["audio_s"] == pytest.approx(sum(len(w) for _, w in outs["port"]) / 24000)


def test_tts_batch_is_seeded_and_refuses_mismatched_lists():
    from mars5_tts_torch import InferenceConfig

    tts = _port_tts(nar_backend="int8")
    refs = _refs(8 * 56, 8 * 40)
    cfg = InferenceConfig(timesteps=3, generate_max_len_override=150, trim_db=200)
    runs = [tts.tts_batch(["hi", "yo there"], refs, ref_transcript=["a", "b"], cfg=cfg, seed=s)
            for s in (2, 2, 5)]
    for (c0, w0), (c1, w1) in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(w0, w1)
        assert np.isfinite(w0).all() and len(w0) > 0
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(runs[0], runs[2]))
    assert int(tts.last_grid.min()) >= 0 and int(tts.last_grid.max()) <= 1024
    with pytest.raises(ValueError):
        tts.tts_batch(["a", "b", "c"], refs, ref_transcript=["a", "b"], cfg=cfg)
    with pytest.raises(ValueError):
        tts.tts_batch(["a"], refs[:1], ref_transcript=["a", "b"], cfg=cfg)
    with pytest.raises(AssertionError):
        tts.tts_batch(["a", "b"], refs, cfg=cfg)
    # use_kv_cache=False is served (the bf16 batched engine), as in the JAX package
    (codes, wav), = tts.tts_batch(["a"], refs[0], "a", cfg=InferenceConfig(
        use_kv_cache=False, timesteps=3, generate_max_len_override=150, trim_db=200))
    assert len(codes) > 0 and np.isfinite(wav).all()


def test_tts_batch_routes_rows_as_the_jax_package(monkeypatch):
    """``ar_backend="fused4"``: 2-8 rows take the quantized batched engine
    (one K2 twin call a step), 1 and 9 rows the bf16 one."""
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine

    calls = []

    def record(fn):
        def run(*a, **k):
            calls.append(("fused" if isinstance(k.get("engine"), FusedEngine) else "bf16",
                          len(a[1])))
            return fn(*a, **k)
        return run

    monkeypatch.setattr(PP, "ar_generate_batched", record(PP.ar_generate_batched))
    tts = _port_tts(ar=fused_ar(), ar_backend="fused4")
    ref = _refs(8 * 40)[0]
    cfg = InferenceConfig(timesteps=2, generate_max_len_override=90, trim_db=200)
    for n in (1, 3, 9):
        outs = tts.tts_batch([f"t{i}" for i in range(n)], ref, ref_transcript="ok", cfg=cfg,
                             seed=1)
        assert len(outs) == n and all(np.isfinite(w).all() for _, w in outs)
    assert calls == [("bf16", 1), ("fused", 3), ("bf16", 9)]
    engine = tts._ar_engine(90, 3)
    fp, dims = engine.fp, engine.dims
    assert dims.batch == 3 and fp is tts._fused_cache[90][0]
    assert tts._fused_cache[90][1].batch == 1
    assert dataclasses.replace(dims, batch=1) == tts._fused_cache[90][1]


@pytest.mark.parametrize("entry", ["tts", "tts_batch"])
@pytest.mark.parametrize("ar_backend", ["bf16", "fused4"])
def test_one_ar_call_a_request_and_k2_through_its_module(monkeypatch, ar_backend, entry):
    """The names the benchmark reads the program through
    (``portbench/record.py``): a ``tts`` or ``tts_batch`` call reaches
    exactly one ``ar_generate*`` callable of ``pipeline``'s namespace, which
    returns a (sequence, n_generated) tuple, or a list of them; on the
    quantized engine every decode step calls K2 as
    ``models/ar_decode_fused.fused_decode_layers``, so a patch of that
    module's global counts it, and on the bf16 engine nothing calls it."""
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.models import ar_decode_fused as F

    calls, k2 = [], []

    def record(fn, name):
        def run(*a, sampling, **k):
            out = fn(*a, sampling=sampling, **k)
            calls.append((name, sampling.max_len, out))
            return out
        return run

    for name in sorted(vars(PP)):
        if name.startswith("ar_generate") and callable(getattr(PP, name)):
            monkeypatch.setattr(PP, name, record(getattr(PP, name), name))
    real = F.fused_decode_layers
    monkeypatch.setattr(F, "fused_decode_layers", lambda *a, **k: k2.append(1) or real(*a, **k))
    tts = _port_tts(ar=fused_ar(), ar_backend=ar_backend)
    ref = _refs(8 * 40)[0]
    cfg = InferenceConfig(timesteps=2, generate_max_len_override=90, trim_db=200)
    if entry == "tts":
        tts.tts("hi there", ref, ref_transcript="ok", cfg=cfg, seed=1)
    else:
        tts.tts_batch(["hi there", "a line"], ref, ref_transcript="ok", cfg=cfg, seed=1)
    (name, max_len, out), = calls
    rows = out if isinstance(out, list) else [out]
    assert (name, len(rows)) == (("ar_generate", 1) if entry == "tts" else
                                 ("ar_generate_batched", 2))
    assert all(isinstance(r, tuple) and len(r) == 2 for r in rows)
    steps = max(n - (len(seq) >= max_len) for seq, n in rows)
    assert steps > 0 and len(k2) == (steps if ar_backend == "fused4" else 0)
