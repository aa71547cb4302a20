"""Serving on one device in the port (``mars5_tts_torch/serving``) against the
JAX package's ``serving/`` at tiny geometry:

* ``ContinuousBatcher``: every row token-identical to the JAX batcher's and
  to its own solo run on the same stream (one bucket, mixed buckets,
  per-request sampling, top_k above the pool default), its refusals, and
  the resumable state (parked rows, row moves);
* ``ContinuousBatcher`` on the quantized engine (``FusedEngine``, the K2
  twin): rows identical to their solo ``ar_generate`` runs on the engine at
  W8 and W4, one K2 call a pool step, and to the JAX
  ``FusedContinuousBatcher(interpret=None)`` at W8 where the two packages'
  solo engines agree;
* NAR waves: wave rows grid-identical to their solo runs under injected
  uniforms (the JAX ``tests/test_nar_waves.py`` cases, mixed voices
  included), through the engine and through ``NarWaveScheduler``, and to
  the JAX engine's wave; the scheduler's grouping, crop and full-wave flush;
* ``chunk_text``, ``crossfade_concat`` and the long-form stitcher and
  stream equal to JAX's on one stand-in synthesizer;
* ``stream_tts`` / ``progressive_tts`` against the JAX ``stream_tts``: in
  this test only, both packages' ``perform_simple_inference`` take one
  injected stream per segment; grids identical, PCM within the Vocos bound
  of ``tests/test_torch_pipeline.py``, and the port's streamed PCM one
  vocode of its emitted grid within atol 2e-5, rtol 1e-4.
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import (make_tokenizers, port_codeclm, port_nar,  # noqa: E402
                                       tiny_models)

K = 1025
AUDIO_ATOL = 1e-4      # tests/test_torch_pipeline.py
POOL_SAMPLING = dict(temperature=0.7, top_k=10, top_p=0.9, typical_p=1.0, alpha_frequency=1.0,
                     alpha_presence=0.4, penalty_window=5, eos_penalty_decay=0.5,
                     eos_penalty_factor=1.0, n_phones_gen=8, eos_idx=49, valid_start=20,
                     valid_end=51, max_len=48)


# ------------------------------------------------------------ the AR pool

@functools.lru_cache(maxsize=None)
def tiny_ar():
    """The JAX continuous tests' AR (``tests/test_continuous.py``): config,
    params and the port's CodecLM."""
    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm

    cfg = CodecLMConfig.tiny(n_vocab=50)
    params = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(0), cfg))
    return cfg, params, port_codeclm(cfg, params)


def _requests(seed, lens, spk_len=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 20, int(n)) for n in lens]
    spks = [rng.integers(0, 1024, (spk_len, 8)) for _ in lens]
    us = [rng.random(POOL_SAMPLING["max_len"]).astype(np.float32) for _ in lens]
    return prompts, spks, us


POOL_CASES = {
    # (prompt lengths, pool kwargs, per-request overrides)
    "one bucket": ([9, 5, 11, 4, 7],
                   dict(batch_size=2, chunk_steps=7, prompt_buckets=(16,)), None),
    "mixed buckets": ([4, 20, 6, 30, 8, 18],
                      dict(batch_size=3, chunk_steps=7, prompt_buckets=(8, 32)), None),
    "per-request sampling": ([9, 5, 11, 6],
                             dict(batch_size=3, chunk_steps=9, prompt_buckets=(16,)),
                             [{"temperature": 1.3, "top_k": 5},
                              {"top_p": 0.5, "alpha_frequency": 2.5},
                              {"typical_p": 0.8, "penalty_window": 3}, {}]),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_rows_equal_jax_pool_and_solo_runs(case):
    from mars5_tts_tpu.models.ar_decode import ArSampling as JS
    from mars5_tts_tpu.serving.continuous import ContinuousBatcher as JBatcher
    from mars5_tts_tpu.serving.continuous import Request as JRequest
    from mars5_tts_torch.models.ar_decode import (ArSampling, ar_generate_batched,
                                                  rows_from_sampling)
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    lens, pool_kw, overrides = POOL_CASES[case]
    overrides = overrides or [None] * len(lens)
    cfg, params, model = tiny_ar()
    prompts, spks, us = _requests(len(lens), lens)
    s = ArSampling(**POOL_SAMPLING)
    pool = ContinuousBatcher(model, s, spk_bucket=16, **pool_kw)
    reqs = [pool.submit(Request(prompt=p, spk_codes=k, uniforms=u, sampling=o))
            for p, k, u, o in zip(prompts, spks, us, overrides)]
    assert len(pool.run()) == len(lens)
    assert pool.chunks_run > 1 and pool.steps_run > pool.chunks_run
    assert all(b > 0 for b in pool.prefills_by_bucket.values())
    jpool = JBatcher(params, cfg, JS(**POOL_SAMPLING), spk_bucket=16, **pool_kw)
    jreqs = [jpool.submit(JRequest(prompt=p, spk_codes=k, uniforms=u, sampling=o))
             for p, k, u, o in zip(prompts, spks, us, overrides)]
    jpool.run()
    for i, (req, jreq, p, k, u, o) in enumerate(zip(reqs, jreqs, prompts, spks, us, overrides)):
        (solo, n_solo), = ar_generate_batched(model, [p], [k], sampling=s, uniforms=u,
                                              rows=rows_from_sampling(s, 1, o))
        np.testing.assert_array_equal(req.tokens, solo, err_msg=f"request {i} solo")
        np.testing.assert_array_equal(req.tokens, np.asarray(jreq.tokens),
                                      err_msg=f"request {i} JAX pool")
        assert req.n_gen == n_solo == jreq.n_gen


def test_request_top_k_above_pool_default_and_refusals():
    from tests.test_torch_fused_decode import SAMPLING, models, port_fused

    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    cfg, params, model = tiny_ar()
    s = ArSampling(**POOL_SAMPLING)                       # top_k 10
    (p,), (k,), (u,) = _requests(9, [6])
    pool = ContinuousBatcher(model, dataclasses.replace(s, top_k=4), batch_size=2,
                             prompt_buckets=(8,), spk_bucket=16, max_top_k=10)
    req = pool.submit(Request(prompt=p, spk_codes=k, uniforms=u, sampling={"top_k": 10}))
    pool.run()
    ref, n_ref = ar_generate(model, p, k, sampling=s, uniforms=u)
    np.testing.assert_array_equal(req.tokens, ref)
    assert req.n_gen == n_ref
    with pytest.raises(ValueError, match="max_top_k"):
        pool.submit(Request(prompt=p, spk_codes=k, sampling={"top_k": 11}))
    with pytest.raises(ValueError, match="exceeds bucket"):
        pool.submit(Request(prompt=np.zeros(20, int), spk_codes=k))
    with pytest.raises(ValueError, match="spk_bucket"):
        pool.submit(Request(prompt=p, spk_codes=np.zeros((17, 8), int)))
    with pytest.raises(ValueError, match="exceeds window"):
        ContinuousBatcher(model, s, prompt_buckets=(8, 64))   # the window is 49 slots
    for rows in (1, 9):
        with pytest.raises(ValueError, match=r"\[2, 8\]"):
            ContinuousBatcher(models()[1], ArSampling(**SAMPLING),
                              engine=FusedEngine(*port_fused(8)), batch_size=rows)


def test_parked_rows_and_row_moves():
    """A parked pool keeps its rows done through a decode chunk (nothing is
    appended, cursors stay); a prefilled row moved into a pool slot and out
    again is the row it was, and decoding it in the pool gives its solo
    tokens."""
    from mars5_tts_torch.models import ar_decode as A

    cfg, params, model = tiny_ar()
    s = A.ArSampling(**POOL_SAMPLING)
    pool = A.make_parked_state(model.cfg, s, 3, torch.float32, "cpu")
    A.decode_chunk(model, s, pool, 5)
    assert pool.done.all() and not pool.cur.any() and pool.steps == 0
    (p,), (k,), (u,) = _requests(4, [7])
    row = A.prefill_row(model, s, p, k, torch.from_numpy(u))
    A.insert_row(pool, row, 1)
    back = A.extract_row(pool, 1)
    for name in ("tokens", "cur", "n_gen", "est_len", "done"):
        np.testing.assert_array_equal(getattr(back, name), getattr(row, name))
    assert torch.equal(back.cache.k, row.cache.k) and torch.equal(back.uniforms, row.uniforms)
    while not pool.done.all():
        A.decode_chunk(model, s, pool, 3)
    assert pool.cur[0] == pool.cur[2] == 0 and pool.steps > 0
    ref, n_ref = A.ar_generate(model, p, k, sampling=s, uniforms=u)
    np.testing.assert_array_equal(pool.tokens[1, : pool.cur[1]], ref)
    assert pool.n_gen[1] == n_ref


# ------------------------------------------------------------ the fused pool

def _fused_requests(seed):
    from tests.test_torch_fused_decode import MAX_LEN

    rng = np.random.default_rng(seed)
    lens = [5, 17, 7, 12, 19]
    prompts = [rng.integers(10, 510, n) for n in lens]
    spks = [rng.integers(0, 1024, (n, 8)) for n in (20, 9, 14, 6, 11)]
    return prompts, spks, [rng.random(MAX_LEN).astype(np.float32) for _ in lens]


@pytest.mark.parametrize("wbits", [8, 4])
def test_fused_pool_rows_equal_solo_runs(wbits, monkeypatch):
    """Five requests, two buckets, through a three-row pool on the K2 twin (the
    ring wraps: window 24): each row's tokens are its solo ``ar_generate``
    run's on the pool's engine and stream, and the pool runs one K2 call a
    step for all its rows."""
    from tests.test_torch_fused_decode import CFG, SAMPLING, models

    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    calls = []
    k2 = D.fused_decode_layers
    monkeypatch.setattr("mars5_tts_torch.models.ar_decode_fused.fused_decode_layers",
                        lambda *a, **k: calls.append(a[1].shape[0]) or k2(*a, **k))
    model = models()[1]
    s = ArSampling(**SAMPLING)
    prompts, spks, us = _fused_requests(wbits)
    engine = FusedEngine(*prepare_fused(model, s.max_len, wbits, batch=3))
    pool = ContinuousBatcher(model, s, engine=engine, batch_size=3, chunk_steps=6,
                             prompt_buckets=(8, 20), spk_bucket=32)
    reqs = [pool.submit(Request(prompt=p, spk_codes=k, uniforms=u))
            for p, k, u in zip(prompts, spks, us)]
    pool.run()
    assert calls == [3] * pool.steps_run and pool.chunks_run > 1
    assert min(pool.prefills_by_bucket.values()) > 0
    for i, (req, p, k, u) in enumerate(zip(reqs, prompts, spks, us)):
        ref, n_ref = ar_generate(model, p, k, sampling=s, uniforms=u, engine=engine)
        np.testing.assert_array_equal(req.tokens, ref, err_msg=f"request {i}")
        assert req.n_gen == n_ref
    assert CFG.sliding_window < max(len(p) for p in prompts) + max(r.n_gen for r in reqs)


def test_fused_pool_equals_jax_fused_pool(monkeypatch):
    """W8, the JAX ``FusedContinuousBatcher(interpret=None)`` (its pure-jnp
    emulation of the kernel) and the port's pool on the same requests, the
    port's step taking the JAX RoPE angles and self-score sum
    (``tests/test_torch_fused_decode.py``): each pool's rows are its own
    package's solo runs, and the two pools give the same tokens but where
    the two engines part on their own. That is request 0 here, at its 10th
    draw; ``test_fused_engines_part_by_one_int8_rounding`` shows where."""
    from tests.test_torch_fused_decode import (CFG, SAMPLING, _jax_rope_flat, _jax_self_scores,
                                               jax_fused, models)

    from mars5_tts_tpu.models.ar_decode import ArSampling as JS
    from mars5_tts_tpu.models.ar_decode_fused import ar_generate_fused as j_solo
    from mars5_tts_tpu.serving.continuous import FusedContinuousBatcher as JPool
    from mars5_tts_tpu.serving.continuous import Request as JRequest
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused
    from mars5_tts_torch.ops.kernels import decode_layer as D
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    prompts, spks, us = _fused_requests(3)
    kw = dict(batch_size=3, chunk_steps=6, prompt_buckets=(8, 20), spk_bucket=32)
    params = jax.tree.map(jnp.asarray, models()[0])
    jpool = JPool(params, CFG, JS(**SAMPLING), interpret=None, wbits=8, **kw)
    engine = FusedEngine(*prepare_fused(models()[1], SAMPLING["max_len"], 8, batch=3))
    pool = ContinuousBatcher(models()[1], ArSampling(**SAMPLING), engine=engine, **kw)
    for p, k, u in zip(prompts, spks, us):
        jpool.submit(JRequest(prompt=p, spk_codes=k, uniforms=u))
        pool.submit(Request(prompt=p, spk_codes=k, uniforms=u))
    jpool.run()
    pool.run()
    got = {tuple(r.prompt): r for r in pool.completed}
    want = {tuple(r.prompt): r for r in jpool.completed}
    differ = []
    for i, (p, k, u) in enumerate(zip(prompts, spks, us)):
        r, jr = got[tuple(p)], want[tuple(p)]
        solo, _ = ar_generate(models()[1], p, k, sampling=ArSampling(**SAMPLING), uniforms=u,
                              engine=engine)
        jsolo, _ = j_solo(params, jax_fused(8)[0], CFG, jax_fused(8)[1], p, k,
                          sampling=JS(**SAMPLING), uniforms=u, interpret=None)
        np.testing.assert_array_equal(r.tokens, solo, err_msg=f"request {i} port solo")
        np.testing.assert_array_equal(jr.tokens, jsolo, err_msg=f"request {i} JAX solo")
        if not np.array_equal(r.tokens, jr.tokens):
            differ.append(i)
            assert not np.array_equal(solo, jsolo)
    assert differ == [0]


def test_fused_engines_part_by_one_int8_rounding(monkeypatch):
    """Where the port's W8 engine (the K2 twin) and the JAX one
    (``interpret=None``) part on request 0 of the test above: both start
    from the JAX solo run's prefill (its int8 K/V and scales) and are fed
    the port's tokens. Through position 11 every step's logits agree within
    f32 rounding and every K/V row each writes is the same int8 values; at
    position 12 the logits jump apart by more than 1e-3 (one quantized value
    moved) with no drift before it. The prefill is not the cause: the two
    packages' prefills quantize to the same int8 K/V, padded or not."""
    from tests.test_torch_fused_decode import (CFG, MAX_LEN, SAMPLING, _jax_rope_flat,
                                               _jax_self_scores, jax_fused, models)

    import mars5_tts_tpu.models.ar_decode_fused as JF
    from mars5_tts_tpu.models.ar import codeclm_prefill, spk_embedding
    from mars5_tts_tpu.ops.pallas.decode_layer import quantize_kv_rows as j_quant
    from mars5_tts_torch.models import ar_decode_fused as F
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate, prefill_rows
    from mars5_tts_torch.ops.kernels import decode_layer as D

    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    params, model = models()
    jp = jax.tree.map(jnp.asarray, params)
    jfp, jdims = jax_fused(8)
    fp, dims = F.prepare_fused(model, MAX_LEN, 8)
    prompts, spks, us = _fused_requests(3)
    p, spk = prompts[0], spks[0]
    tokens, _ = ar_generate(model, p, spk, sampling=ArSampling(**SAMPLING), uniforms=us[0],
                            engine=F.FusedEngine(fp, dims))

    # the JAX solo run's prefill: prompt padded to 23, speaker codes to 32
    pb, n_layers, d = min(64, dims.window - 1), jdims.n_layers, jdims.dim
    tok = np.zeros((1, pb), np.int32)
    tok[0, :len(p)] = p
    codes = np.full((1, 32, 8), CFG.codebook_size - 1, np.int32)
    codes[0, :len(spk)] = spk
    _, (k, v) = codeclm_prefill(jp, CFG, tok, spk_embedding(jp, CFG, codes))
    k8, ks = j_quant(k[:, 0].reshape(n_layers, pb + 1, d))
    v8, vs = j_quant(v[:, 0].reshape(n_layers, pb + 1, d))
    ck = jnp.zeros((n_layers, jdims.w_pad, d), jnp.int8).at[:, :pb + 1].set(k8)
    cv = jnp.zeros_like(ck).at[:, :pb + 1].set(v8)
    sc = (jnp.zeros((n_layers, 2, jdims.w_pad), jnp.float32).at[:, 0, :pb + 1].set(ks)
          .at[:, 1, :pb + 1].set(vs))
    # the port's own prefill, unpadded, quantizes to the same int8 K/V
    own = F.FusedCache(dims, torch.device("cpu"))
    own.write_prompt(0, prefill_rows(model, [p], [spk], dims.window)[1][0])
    n = len(p) + 1
    assert np.array_equal(own.k[:, 0, :n].numpy(), np.asarray(k8[:, :n]))
    assert np.array_equal(own.v[:, 0, :n].numpy(), np.asarray(v8[:, :n]))

    cache = F.FusedCache(dims, torch.device("cpu"))
    w = dims.window
    cache.k[:, 0] = torch.from_numpy(np.array(ck[:, :w]))
    cache.v[:, 0] = torch.from_numpy(np.array(cv[:, :w]))
    cache.scales[:, 0] = torch.from_numpy(np.array(sc[:, :, :w]))

    diffs, same_kv = [], []
    for i in range(8):
        pos, last = len(p) + 1 + i, int(tokens[len(p) + i])
        logits = F.fused_step(fp, dims, CFG, [last], [pos], cache).numpy()[0]
        jl, ck, cv, sc = JF._fused_backbone_step(jfp, jdims, CFG, jnp.asarray([last]),
                                                 jnp.int32(pos), ck, cv, sc, None)
        diffs.append(float(np.abs(np.asarray(jl)[0] - logits).max()))
        slot = pos % w
        same_kv.append(np.array_equal(cache.k[:, 0, slot].numpy(), np.asarray(ck[:, slot]))
                       and np.array_equal(cache.v[:, 0, slot].numpy(), np.asarray(cv[:, slot])))
    part = len(p) + 1 + next(i for i, x in enumerate(diffs) if x > 1e-3)
    assert part == 12, diffs
    assert max(diffs[:part - len(p) - 1]) <= 2.5e-7 and all(same_kv[:part - len(p) - 1])


# ------------------------------------------------------------ NAR waves

@functools.lru_cache(maxsize=None)
def wave_nar():
    """The JAX wave tests' NAR (``tests/test_nar_waves.py``)."""
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar

    cfg = ResidualTransformerConfig.tiny(n_text_vocab=32)
    params = jax.tree.map(np.asarray, init_nar(jax.random.PRNGKey(0), cfg))
    return cfg, params, port_nar(cfg, params)


def _wave_dsh(deep):
    from mars5_tts_torch.config import DSH

    return DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=deep, jump_len=1,
               jump_n_sample=1, q0_override_steps=2, enable_kevin_scaled_inference=True,
               guidance_interval=(0.0, 0.6))


def _engine(batch, T, dsh, **kw):
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion

    return perform_simple_inference(wave_nar()[2], batch, MultinomialDiffusion(K, T), T, dsh,
                                    **kw).numpy()


@pytest.mark.parametrize("layout", ["deep", "shallow", "mixed voices"])
def test_wave_rows_match_solo_and_jax(layout):
    """Two requests padded to one wave (gen bucket 8; mixed voices: prompt
    lengths 4 and 2) under per-request streams laid out as the wave: each
    wave row equals the request's solo run, and the wave grid the JAX
    engine's on the same batch."""
    import mars5_tts_tpu.config as JC
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer

    cfg, params, _ = wave_nar()
    T, lt = 5, 6
    deep = layout != "shallow"
    lcs = [4, 2] if layout == "mixed voices" else [4, 4]
    lgs = [5, 7]
    lx = 8 if layout != "mixed voices" else 7
    rng = np.random.default_rng(len(layout))
    c_texts = [rng.integers(0, 32, lt), rng.integers(0, 32, lt - 2)]
    c_codes = [rng.integers(0, 1024, (lc, 8)) for lc in lcs]
    l0 = [rng.integers(0, 1024, lg) for lg in lgs]
    length = (max(lcs) if deep else 0) + lx
    u_rows = [rng.random((T, 2, 1, length, 8, K)).astype(np.float32) for _ in lgs]
    x_init_rows = [rng.integers(0, K, (1, lx, 8)) for _ in lgs]
    dsh = _wave_dsh(deep)
    solo = []
    for j, (lc, lg) in enumerate(zip(lcs, lgs)):
        batch = (c_texts[j][None], c_codes[j][None], [len(c_texts[j])], [lc],
                 np.repeat(l0[j][:, None], 8, axis=1)[None], np.zeros((1, lg), bool))
        solo.append(_engine(batch, T, dsh, uniforms=u_rows[j][:, :, :, :(lc if deep else 0) + lg],
                            x_init=x_init_rows[j][:, :lg])[0])
    bs = len(lgs)
    c_text = np.zeros((bs, lt), np.int64)
    codes = np.zeros((bs, max(lcs), 8), np.int64)
    x = np.zeros((bs, lx, 8), np.int64)
    xpm = np.ones((bs, lx), bool)
    for j, (lc, lg) in enumerate(zip(lcs, lgs)):
        c_text[j, : len(c_texts[j])] = c_texts[j]
        codes[j, :lc] = c_codes[j]
        x[j, :lg] = l0[j][:, None]
        xpm[j, :lg] = False
    batch = (c_text, codes, np.asarray([len(c) for c in c_texts]), np.asarray(lcs), x, xpm)
    u = np.concatenate(u_rows, axis=2)
    x_init = np.concatenate(x_init_rows, axis=0)
    wave = _engine(batch, T, dsh, uniforms=u, x_init=x_init)
    for j, lg in enumerate(lgs):
        np.testing.assert_array_equal(wave[j, :lg], solo[j], err_msg=f"row {j}")
    jdsh = JC.DSH(**dataclasses.asdict(dsh))
    want = np.asarray(j_infer(params, cfg, batch, JDiff(K, timesteps=T), T, jdsh, uniforms=u,
                              x_init=x_init))
    np.testing.assert_array_equal(wave, want)


def _scheduler(deep=True, **kw):
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.serving.nar_waves import NarWaveScheduler

    T = kw.pop("T", 4)
    return NarWaveScheduler(wave_nar()[2], MultinomialDiffusion(K, timesteps=T), T,
                            _wave_dsh(deep), **kw)


def test_scheduler_rows_equal_solo_runs(monkeypatch):
    """Three compatible requests (Lc 4, gen bucket 8) in one scheduler wave,
    each drawing its own injected stream (this test wraps the scheduler's
    engine call to inject them), equal each request's own one-row wave."""
    from mars5_tts_torch.serving import nar_waves
    from mars5_tts_torch.serving.nar_waves import NarRequest

    engine = nar_waves.perform_simple_inference
    streams = {}

    def injected(nar, batch, diff, T, dsh, **kw):
        seeds = [streams["by_text"][tuple(t[:n])] for t, n in zip(batch[0], batch[2])]
        rs = [np.random.default_rng(sd) for sd in seeds]
        u = np.concatenate([r.random((T, 2, 1, 4 + batch[4].shape[1], 8, K)).astype(np.float32)
                            for r in rs], axis=2)
        x_init = np.concatenate([r.integers(0, K, (1, batch[4].shape[1], 8)) for r in rs])
        kw.pop("generator")
        return engine(nar, batch, diff, T, dsh, uniforms=u, x_init=x_init, **kw)

    monkeypatch.setattr(nar_waves, "perform_simple_inference", injected)
    rng = np.random.default_rng(5)
    reqs = [NarRequest(c_text=rng.integers(0, 32, n), c_codes=rng.integers(0, 1024, (4, 8)),
                       l0_codes=rng.integers(0, 1024, lg), seed=i)
            for i, (n, lg) in enumerate([(5, 6), (3, 8), (6, 7)])]
    streams["by_text"] = {tuple(r.c_text): 40 + i for i, r in enumerate(reqs)}
    wave = _scheduler(wave_size=3, gen_buckets=(8,), text_bucket=8)
    for r in reqs:
        wave.submit(r)
    wave.flush()
    assert wave.waves_run == 1
    for i, r in enumerate(reqs):
        alone = _scheduler(wave_size=3, gen_buckets=(8,), text_bucket=8)
        a = alone.submit(NarRequest(c_text=r.c_text, c_codes=r.c_codes, l0_codes=r.l0_codes))
        alone.flush()
        np.testing.assert_array_equal(r.grid, a.grid, err_msg=f"request {i}")
        np.testing.assert_array_equal(r.grid[:, 0], r.l0_codes)


def test_scheduler_groups_crops_and_flushes_full_waves():
    from mars5_tts_torch.serving.nar_waves import NarRequest

    rng = np.random.default_rng(1)
    sched = _scheduler(wave_size=2, gen_buckets=(6, 10), text_bucket=8)
    reqs = [sched.submit(NarRequest(c_text=rng.integers(0, 32, 5),
                                    c_codes=rng.integers(0, 1024, (lc, 8)),
                                    l0_codes=rng.integers(0, 1024, lg), seed=lg))
            for lc, lg in [(4, 5), (4, 6), (4, 9), (3, 5), (4, 5)]]
    assert len(sched.flush()) == 5
    assert sched.waves_run == 4      # (4, 6) x 2 + 1 overflow, (4, 10), (3, 6)
    for r in reqs:
        assert r.grid.shape == (len(r.l0_codes), 8)
        np.testing.assert_array_equal(r.grid[:, 0], r.l0_codes)
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(NarRequest(c_text=rng.integers(0, 32, 5),
                                c_codes=rng.integers(0, 1024, (4, 8)),
                                l0_codes=rng.integers(0, 1024, 11)))
    with pytest.raises(ValueError, match="text length"):
        sched.submit(NarRequest(c_text=rng.integers(0, 32, 9),
                                c_codes=rng.integers(0, 1024, (4, 8)),
                                l0_codes=rng.integers(0, 1024, 5)))

    sched = _scheduler(wave_size=2, gen_buckets=(6,), text_bucket=8)

    def req(lg, seed):
        return sched.submit(NarRequest(c_text=rng.integers(0, 32, 5),
                                       c_codes=rng.integers(0, 1024, (4, 8)),
                                       l0_codes=rng.integers(0, 1024, lg), seed=seed))
    r1, r2, r3 = req(5, 0), req(6, 1), req(5, 2)
    assert sched.flush_full_waves() == 1 and len(sched.completed) == 2
    assert sched.queue == [r3] and r3.grid is None
    assert sched.flush_full_waves() == 0 and sched.queue == [r3]
    assert len(sched.flush()) == 3 and sched.waves_run == 2
    for r in (r1, r2, r3):
        assert r.grid.shape == (len(r.l0_codes), 8)


# ------------------------------------------------------------ long form

TEXTS = ["One sentence here. Two now! Three follows? Four ends. Five more.",
         "A very long sentence, with commas, that goes on, and on, past the budget, surely. "
         "Short one.",
         "Short. " + "x" * 70 + ". Tail, end.",
         "   ", "Single"]


@pytest.mark.parametrize("max_chars", [1, 16, 25, 300])
def test_chunk_text_and_crossfade_equal_jax(max_chars):
    from mars5_tts_tpu.serving import chunk_text as j_chunk
    from mars5_tts_tpu.serving import crossfade_concat as j_fade
    from mars5_tts_torch.serving import chunk_text, crossfade_concat

    for text in TEXTS:
        assert chunk_text(text, max_chars) == j_chunk(text, max_chars)
    rng = np.random.default_rng(max_chars)
    segs = [rng.standard_normal(n).astype(np.float32) for n in (900, 3, 2000, 480)]
    for kw in (dict(), dict(fade_ms=20.0, gap_ms=0.0), dict(fade_ms=1000.0, gap_ms=5.0),
               dict(fade_ms=0.0, gap_ms=0.0)):
        np.testing.assert_array_equal(crossfade_concat(segs, **kw), j_fade(segs, **kw))
    assert len(crossfade_concat([])) == 0
    with pytest.raises(ValueError):
        chunk_text("a", 0)


def chunk_text_of(text, max_chars):
    from mars5_tts_torch.serving import chunk_text

    return chunk_text(text, max_chars)


class _StandIn:
    """A synthesizer of audio keyed on (text, seed), and its chunk configs."""

    sr = 24000

    def __init__(self, seg_len=None):
        self.last_timing, self.seg_len, self.seen_T = {}, seg_len, []

    def tts(self, text, ref_audio, ref_transcript=None, cfg=None, seed=0):
        rng = np.random.default_rng(zlib.crc32(f"{text}|{seed}".encode()))
        n = self.seg_len if self.seg_len is not None else 2000 + (seed % 5) * 700
        self.last_timing = {"seed": seed, "text": text}
        self.seen_T.append(cfg.timesteps)
        return None, (rng.standard_normal(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(fade_ms=20.0, gap_ms=60.0), dict(fade_ms=20.0, gap_ms=0.0),
                                dict(fade_ms=1000.0, gap_ms=5.0), dict(fade_ms=0.0, gap_ms=0.0)])
def test_longform_and_stream_equal_jax(kw):
    from mars5_tts_tpu.serving import stream_longform as j_stream
    from mars5_tts_tpu.serving import synthesize_longform as j_synth
    from mars5_tts_torch import InferenceConfig
    from mars5_tts_torch.serving import stream_longform, synthesize_longform

    seg = 900 if kw["fade_ms"] >= 1000 else None
    batch = synthesize_longform(_StandIn(seg), TEXTS[0], None, "", max_chars=16, **kw)
    want = j_synth(_StandIn(seg), TEXTS[0], None, "", max_chars=16, **kw)
    np.testing.assert_array_equal(batch.audio, want.audio)
    assert batch.chunks == want.chunks and batch.timings == want.timings
    model = _StandIn(seg)
    stream = list(stream_longform(model, TEXTS[0], None, "", max_chars=16, **kw,
                                  cfg=InferenceConfig(timesteps=200), first_chunk_timesteps=50))
    jstream = list(j_stream(_StandIn(seg), TEXTS[0], None, "", max_chars=16, **kw,
                            first_chunk_timesteps=50))
    assert model.seen_T == [50] + [200] * (len(stream) - 1)
    assert [c.text for c in stream] == batch.chunks and stream[-1].final
    joined = np.concatenate([c.pcm for c in stream])
    np.testing.assert_array_equal(joined, batch.audio)
    np.testing.assert_array_equal(joined, np.concatenate([c.pcm for c in jstream]))
    ramp = [list(fn(_StandIn(2400), TEXTS[1], None, "", max_chars=90, first_chunk_chars=30))
            for fn in (stream_longform, j_stream)]
    assert [c.text for c in ramp[0]] == [c.text for c in ramp[1]]
    assert len(ramp[0]) > len(chunk_text_of(TEXTS[1], 90))


# ------------------------------------------------------------ progressive

def _tts_pair(**kw):
    import mars5_tts_tpu.pipeline as JP
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree

    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(tiny["ar"], tiny["nar"], cfgs["ar"], cfgs["nar"],
                                   texttok=texttok, speechtok=speechtok,
                                   encodec_params=tiny["encodec"], vocos_params=tiny["vocos"],
                                   encodec_cfg=cfgs["encodec"], vocos_cfg=cfgs["vocos"], **kw)
    ptts = Mars5TTS.from_params(port_codeclm(cfgs["ar"], tiny["ar"]),
                                port_nar(cfgs["nar"], tiny["nar"]), texttok=texttok,
                                speechtok=speechtok, encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), **kw)
    return jtts, ptts


def _inject_segments(monkeypatch, T):
    """Both packages' diffusion calls take, in this test, an injected stream
    and initial noise made from the call's count and geometry."""
    import mars5_tts_tpu.serving.progressive as JPr
    import mars5_tts_torch.pipeline as PP

    calls = {"jax": 0, "port": 0}

    def wrap(fn, name, drop):
        def run(*a, **k):
            batch, dsh = (a[2], a[5]) if name == "jax" else (a[1], a[4])
            lc = np.shape(batch[1])[1] if dsh.deep_clone else 0
            lx = np.shape(batch[4])[1]
            rng = np.random.default_rng(1000 * calls[name] + lc)
            calls[name] += 1
            k.pop(drop)
            return fn(*a, uniforms=rng.random((T, 2, 1, lc + lx, 8, K)).astype(np.float32),
                      x_init=rng.integers(0, K, (1, lx, 8)), **k)
        return run
    monkeypatch.setattr(JPr, "perform_simple_inference",
                        wrap(JPr.perform_simple_inference, "jax", "key"))
    monkeypatch.setattr(PP, "perform_simple_inference",
                        wrap(PP.perform_simple_inference, "port", "generator"))
    return calls


@pytest.mark.parametrize("deep", [False, True])
def test_stream_tts_matches_jax(monkeypatch, deep):
    """Shallow and deep clone, several segments, buckets 16 / 8 on both
    models, the AR on shared uniforms: each chunk's grid and frame range
    equal the JAX stream's, its PCM within the Vocos bound; the port's
    concatenated PCM is one vocode of its emitted grid (atol 2e-5, rtol
    1e-4); under deep clone the AR's regenerated prompt span is dropped."""
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig
    from mars5_tts_tpu.models import ar_decode as JA
    from mars5_tts_tpu.serving import stream_tts as j_stream
    from mars5_tts_torch.serving import progressive_tts, stream_tts

    T = 4
    u = np.random.default_rng(3).random(4096).astype(np.float32)
    for mod, fn in ((JP, JA.ar_generate), (PP, PP.ar_generate)):
        monkeypatch.setattr(mod, "ar_generate", lambda *a, _f=fn, sampling, seed=0, **k: _f(
            *a, sampling=sampling, uniforms=u[:sampling.max_len], **k))
    calls = _inject_segments(monkeypatch, T)
    jtts, ptts = _tts_pair(nar_gen_bucket=16, nar_text_bucket=8)
    ref = (np.random.default_rng(7).standard_normal(8 * 30) * 0.1).astype(np.float32)
    cfg = InferenceConfig(timesteps=T, generate_max_len_override=100, trim_db=200,
                          deep_clone=deep)
    kw = dict(ref_transcript="a ref" if deep else "", cfg=cfg, seed=1, seg_frames=8,
              ctx_frames=8, vocode_margin=16)
    want = list(j_stream(jtts, "the quick brown rat", ref, **kw))
    got = list(stream_tts(ptts, "the quick brown rat", ref, **kw))
    assert len(got) == len(want) >= 3 and calls["jax"] == calls["port"] == len(got)
    for c, w in zip(got, want):
        assert (c.frame_start, c.frame_end) == (w.frame_start, w.frame_end)
        np.testing.assert_array_equal(c.grid, np.asarray(w.grid))
        np.testing.assert_allclose(c.pcm, w.pcm, atol=AUDIO_ATOL)
        assert c.timing is not None and "total_s" in c.timing
    grid = np.concatenate([c.grid for c in got])
    full = ptts.vocode(grid)[: len(grid) * ptts.vocos.cfg.hop_length]
    stream = np.concatenate([c.pcm for c in got])
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, atol=2e-5, rtol=1e-4)
    if deep:
        codes, _ = ptts.tts("the quick brown rat", ref, ref_transcript="a ref", cfg=cfg, seed=1)
        skip = ptts.encode_reference(ref).shape[-1]
        np.testing.assert_array_equal(grid[:, 0], codes[skip:])
    g2, a2 = progressive_tts(ptts, "the quick brown rat", ref, **kw)
    np.testing.assert_array_equal(g2.shape, grid.shape)
    assert a2.shape == stream.shape
    with pytest.raises(ValueError):
        next(stream_tts(ptts, "x", ref, ref_transcript="", cfg=cfg, seg_frames=0))
    with pytest.raises(ValueError):
        next(stream_tts(ptts, "x", ref, ref_transcript="", cfg=cfg, keep_spk_prompt=False,
                        ctx_frames=0))
