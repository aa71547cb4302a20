"""The DeepSeek-V2 block as the port's codec LM (``attention="mla"`` with
experts), held against the plain reference ``tests/plain_deepseek_v2.py`` at
a tiny DeepSeek-V2-shaped geometry, both in float32 on the CPU: dim 128, 4
heads (nope 32, rope 16, v 32), a 64-wide latent, 8 experts top-2 of width
48 with 2 shared, 3 layers of which layer 0 is dense.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests import plain_deepseek_v2 as R

N_VOCAB = 258 + 1025 + 117      # the stand-in tokenizers' ids first, then rows never fed


def _cfg(**kw):
    from mars5_tts_torch.models.ar import CodecLMConfig

    base = dict(n_vocab=N_VOCAB, dim=128, n_heads=4, n_kv_heads=4, head_dim=48, n_layers=3,
                hidden_dim=96, sliding_window=4096, norm_eps=1e-6, n_spk_layers=2,
                spk_hidden_dim=192, attention="mla", kv_lora_rank=64, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32, rope_factor=40.0,
                rope_original_max_pos=4096, rope_mscale=0.707, rope_mscale_all_dim=0.707,
                n_routed_experts=8, n_shared_experts=2, n_experts_per_tok=2, moe_hidden_dim=48,
                first_k_dense=1)
    return CodecLMConfig(**(base | kw))


def _model(seed=0, dtype=torch.float32, **kw):
    from mars5_tts_torch.models.ar import CodecLM

    cfg = _cfg(**kw)
    m = CodecLM(cfg).init_(torch.Generator().manual_seed(seed)).to(dtype).eval()
    return m, {k: v.float() for k, v in m.state_dict().items()}, dataclasses.asdict(cfg)


def _inputs(n_tok=40, n_spk=30, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 258 + 1025, n_tok)),
            torch.as_tensor(rng.integers(0, 1024, (n_spk, 8))))


# f32 against f32: the sums differ only in order (the decode step's absorbed
# form regroups the latent products), ~1e-6 of the logits' scale; bf16
# weights move the same logits by ~1e-2 of it (held below)
LOGIT_TOL = 2e-5


@torch.no_grad()
def test_prefill_logits_match_reference():
    m, p, c = _model()
    toks, spk = _inputs()
    want = R.forward(p, c, toks, spk)
    got, states = m.prefill(toks[None], m.spk_embedding(spk[None]))
    scale = float(want.abs().max())
    assert float((got[0] - want).abs().max()) <= LOGIT_TOL * scale
    c0, k_pe = states[0]
    assert c0.shape == (1, 41, 64) and k_pe.shape == (1, 41, 16)


@torch.no_grad()
def test_decode_through_latent_cache_matches_full_forward():
    """Prefill 20 tokens, then feed the rest one at a time through the latent
    ring (a 24-slot ring, so it wraps), each step's logits against the
    reference's full forward at the same position, teacher-forced."""
    from mars5_tts_torch.models import ar_decode as AD

    toks, spk = _inputs(n_tok=40)
    errs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m, p, c = _model(dtype=dtype)
        c["sliding_window"] = 23            # the reference's band = a 24-slot ring's
        want = R.forward(p, c, toks, spk)
        _, states = AD.prefill_rows(m, [toks[:20].numpy()], [spk.numpy()], 4096)
        cache = AD.make_cache(m.cfg, 1, 24, dtype, "cpu")
        cache.write_prompt(0, states[0])
        worst = 0.0
        for i in range(20, 40):
            got = AD.decode_step(m, toks[i:i + 1].numpy(), np.array([i + 1]), cache)
            worst = max(worst, float((got[0] - want[i + 1]).abs().max()))
        errs[name] = worst / float(want.abs().max())
    assert errs["f32"] <= LOGIT_TOL, errs
    assert errs["bf16"] > 10 * LOGIT_TOL, errs          # the tolerance sees bf16


def _near_ties(probs, k, gap=1e-6):
    """Tokens whose k-th and (k+1)-th probabilities lie within ``gap``."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) < gap


@torch.no_grad()
def test_moe_layer_matches_reference():
    """The expert layer over 200 tokens, grouped (a prompt) and through K10's
    twin (8-row decode steps), against the reference's expert loop; tokens
    whose routing is a near-tie are counted and left out."""
    m, p, c = _model()
    ff = m.ar.layers[1].feed_forward
    x = torch.randn(200, 128, generator=torch.Generator().manual_seed(3))
    pre = "ar.layers.1.feed_forward."
    probs, _, _ = R.route(p, pre, c, x)
    ties = _near_ties(probs, 2)
    assert int(ties.sum()) <= 4
    want = R.moe(p, pre, c, x)[~ties]
    scale = float(want.abs().max())
    grouped = ff(x)[~ties]
    stepped = torch.cat([ff(x[i:i + 8], decode=True) for i in range(0, 200, 8)])[~ties]
    assert float((grouped - want).abs().max()) <= 1e-5 * scale
    assert float((stepped - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_k10_twin_matches_reference_expert_loop(rows):
    from mars5_tts_torch.ops.kernels.moe_decode import moe_decode_ref

    _, p, c = _model()
    pre = "ar.layers.2.feed_forward."
    x = torch.randn(rows, 128, generator=torch.Generator().manual_seed(rows))
    _, w, ids = R.route(p, pre, c, x)
    load = torch.zeros(8, dtype=torch.int32)
    got = moe_decode_ref(x, ids.int(), w, p[pre + "w13"], p[pre + "w2"],
                         p[pre + "shared.w1.weight"], p[pre + "shared.w3.weight"],
                         p[pre + "shared.w2.weight"], load=load)
    want = R.moe(p, pre, c, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(load, torch.bincount(ids.reshape(-1), minlength=8).int())


def test_yarn_tables_at_published_values():
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.ops.rope import yarn_inv_freq, yarn_range

    pub = dict(qk_rope_head_dim=64, rope_factor=40.0,
               rope_original_max_pos=4096, rope_beta_fast=32.0, rope_beta_slow=1.0,
               rope_mscale=0.707, rope_mscale_all_dim=0.707, head_dim=192)
    t = R.yarn(pub)
    assert (t["low"], t["high"]) == (10, 23) == yarn_range(64, 10000.0, 4096, 32.0, 1.0)
    assert t["scale"] == pytest.approx(0.114721, abs=1e-6)
    assert t["cos_scale"] == 1.0
    assert torch.equal(yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0), t["inv_freq"])
    # the ramp's ends: base frequencies below pair 10, a fortieth above pair 23
    base = 10000.0 ** (-2 * torch.arange(32, dtype=torch.float64) / 64)
    assert torch.allclose(t["inv_freq"][:10].double(), base[:10], rtol=1e-7)
    assert torch.allclose(t["inv_freq"][23:].double(), base[23:] / 40, rtol=1e-7)
    with torch.device("meta"):
        m = CodecLM(CodecLMConfig(n_vocab=16, dim=2048, n_heads=16, n_kv_heads=16,
                                  n_layers=1, attention="mla", kv_lora_rank=512,
                                  qk_nope_head_dim=128, v_head_dim=128, hidden_dim=64,
                                  spk_hidden_dim=64, **{k: v for k, v in pub.items()}))
    assert m.ar.layers[0].attention.scale == pytest.approx(t["scale"], rel=1e-12)


# ------------------------------------------------------------ the pipeline

def _tts(ar_model, **kw):
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree
    from tests.torch_port_fixtures import make_tokenizers, port_nar, tiny_models

    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    return Mars5TTS.from_params(ar_model, port_nar(cfgs["nar"], tiny["nar"]), texttok=texttok,
                                speechtok=speechtok, encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), device="cpu", **kw)


def _reference_tokens(p, c, prompt, spk, s, u, est_len):
    """The tokens the port's sampler draws from the reference's logits (its
    full forward over the tokens so far, each step) on uniforms ``u``."""
    from mars5_tts_torch.models import ar_decode as AD

    st = AD.new_state([prompt], s, c["n_vocab"], torch.as_tensor(u[:, None]), None,
                      est_lens=[est_len])
    rows = AD.rows_from_sampling(s, 1)

    class Reference(AD.Route):
        def body(self, state):
            return R.forward(p, c, torch.as_tensor(state.tokens[0, :state.cur[0]]),
                             torch.as_tensor(spk))[-1][None]

    AD.sample_update(st, Reference().body(st), s, rows)
    return AD.decode_loop(st, s, rows, Reference()).results()[0]


@pytest.mark.parametrize("entry", ["tts", "tts_batch"])
def test_pipeline_ar_tokens_are_reference_draws(monkeypatch, entry):
    """``tts`` and ``tts_batch`` with the new AR on ``ar_backend="bf16"``: the
    AR's tokens (through ``ar_generate`` / ``ar_generate_batched`` and the
    injected uniforms) are the draws of the reference's logits on the same
    uniforms, and the call reports the expert-load tally."""
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_torch import InferenceConfig

    m, p, c = _model(seed=4)
    tts = _tts(m)
    u = np.random.default_rng(5).random((4096, 2)).astype(np.float32)
    calls = []

    def inject(fn):
        def run(model, prompts, spk, *, sampling, seed=0, **k):
            n = len(prompts) if isinstance(prompts, list) else 1
            out = fn(model, prompts, spk, sampling=sampling,
                     uniforms=u[:sampling.max_len, :n] if n > 1 else u[:sampling.max_len, 0],
                     **k)
            calls.append((prompts, spk, sampling, k.get("est_lens"), out))
            return out
        return run

    monkeypatch.setattr(PP, "ar_generate", inject(PP.ar_generate))
    monkeypatch.setattr(PP, "ar_generate_batched", inject(PP.ar_generate_batched))
    refs = [(np.random.default_rng(11 + i).standard_normal(n) * 0.1).astype(np.float32)
            for i, n in enumerate((7 * 16 * 8, 5 * 16 * 8))]
    cfg = InferenceConfig(timesteps=3, generate_max_len_override=60, trim_db=200,
                          deep_clone=False)
    if entry == "tts":
        tts.tts("hi there", refs[0], ref_transcript="", cfg=cfg, seed=3)
        (prompt, spk, s, _, (seq, n_gen)), = calls
        rows = [(prompt, spk, s.n_phones_gen, u[:s.max_len, 0], seq)]
    else:
        tts.tts_batch(["hi there", "a b"], refs, ["", ""], cfg=cfg, seed=3)
        (prompts, spks, s, est, outs), = calls
        rows = [(prompts[i], spks[i], est[i], u[:s.max_len, i], outs[i][0]) for i in range(2)]
    for prompt, spk, est, ui, seq in rows:
        want, _ = _reference_tokens(p, c, np.asarray(prompt), np.asarray(spk), s, ui, est)
        np.testing.assert_array_equal(seq, want)
    load = tts.last_timing["ar_expert_load"]
    assert len(load["max"]) == 2 and all(mx >= mn > 0 for mx, mn in zip(load["max"],
                                                                          load["mean"]))


def test_parked_and_batched_states_keep_working():
    """The latent ring's row operations: a row taken out of a batched state
    and put into a parked pool decodes as it did in its batch: the same
    tokens, its latents equal up to f32 summation order (the absorbed
    products run as GEMMs over all the rows of a step, whose kernels the
    row count picks)."""
    from mars5_tts_torch.models import ar_decode as AD

    m, _, _ = _model(seed=2)
    s = AD.ArSampling(max_len=40, valid_start=258, valid_end=258 + 1025, eos_idx=258 + 1024,
                      top_k=50, top_p=0.9)
    toks, spk = _inputs(n_tok=12)
    prompts = [toks[:12].numpy(), toks[:9].numpy()]
    u = torch.as_tensor(np.random.default_rng(3).random((40, 2)).astype(np.float32))
    batch = AD.prefill_state(m, s, prompts, [spk.numpy()] * 2, u)
    assert isinstance(batch.cache, AD.LatentCache)
    pool = AD.make_parked_state(m.cfg, s, 3, torch.float32, "cpu")
    AD.insert_row(pool, AD.extract_row(batch, 1), 2)
    AD.decode_chunk(m, s, batch, 5)
    AD.decode_chunk(m, s, pool, 5)
    np.testing.assert_array_equal(pool.tokens[2], batch.tokens[1])
    assert torch.equal(pool.cache.ckv[:, 2, :10], batch.cache.ckv[:, 1, :10])   # the prompt
    torch.testing.assert_close(pool.cache.ckv[:, 2], batch.cache.ckv[:, 1], rtol=0, atol=1e-5)


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw", [dict(ar_backend="fused"), dict(ar_backend="fused4"),
                                dict(ar_backend="fused4", head4=True)])
def test_quantized_routes_refuse_the_block(kw):
    m, _, _ = _model()
    with pytest.raises(ValueError, match="ar_backend='bf16'"):
        _tts(m, **kw)


def test_k2_dims_and_fused_pool_refuse_the_block():
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.ops.kernels.decode_layer import make_dims

    m, _, _ = _model()
    with pytest.raises(ValueError, match="K2"):
        make_dims(m.cfg, 100)
    with pytest.raises(ValueError, match="K2"):
        prepare_fused(m, 100, 4, batch=2)        # a quantized pool's engine


def test_tensor_parallelism_refuses_the_block():
    from mars5_tts_torch.parallel.sharding import codeclm_specs

    m, _, _ = _model()
    with pytest.raises(ValueError, match="tensor parallelism"):
        codeclm_specs(m, 2)
    assert codeclm_specs(m, 1) is not None


def test_deploy_predictor_refuses_the_block(tmp_path, monkeypatch):
    """The deploy ``Predictor`` (its default ``fused4`` AR) on a checkpoint of
    the new block raises at set-up."""
    from mars5_tts_torch.deploy.predict import Predictor
    from mars5_tts_torch.hub import save_checkpoint
    from tests.torch_port_fixtures import make_tokenizers, write_port_files

    files = write_port_files(tmp_path)
    m, _, c = _model()
    _, _, text_str, speech_str = make_tokenizers()
    ar = tmp_path / "mla_ar.pt"
    save_checkpoint(ar, {k: v.numpy() for k, v in m.state_dict().items()},
                    {"texttok.model": text_str, "speechtok.model": speech_str}, config=c)
    for k in ("MARS5_AR_BACKEND", "MARS5_HEAD4"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="ar_backend='bf16'"):
        Predictor().setup(str(ar), files["nar"], device="cpu")


def test_config_refuses_incomplete_mla_and_moe():
    with pytest.raises(ValueError, match="mla"):
        _cfg(kv_lora_rank=0)
    with pytest.raises(ValueError, match="head_dim"):
        _cfg(head_dim=64)
    with pytest.raises(ValueError, match="experts"):
        _cfg(n_experts_per_tok=9)


@pytest.mark.parametrize("dim,heads,k1", [(2048, 16, False), (1536, 24, True)])
def test_speaker_encoder_route_checks_the_head_dim(monkeypatch, dim, heads, k1):
    """On the card's route selection (``kernel_route`` forced), a 600-token
    speaker encoder at 16 heads of 128 (the DeepSeek-V2 AR's) runs plain
    ``sdpa``; the MARS5 AR's 24 heads of 64 still take K1."""
    from mars5_tts_torch.models.layers import TransformerEncoder
    from mars5_tts_torch.ops import attention as PA

    monkeypatch.setattr(PA, "kernel_route", lambda _t: True)
    calls = []
    real = PA.mha_kernel.mha
    monkeypatch.setattr(PA.mha_kernel, "mha",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    enc = TransformerEncoder(dim, heads, 64, 1).eval()
    with torch.no_grad():
        out = enc(torch.randn(1, 600, dim))
    assert torch.isfinite(out).all()
    assert calls == ([(1, 600, heads, 64)] if k1 else [])


def test_config_dict_keeps_the_release_schema():
    """``CodecLMConfig.to_dict`` (a checkpoint's config): the MARS5 block's
    is the release's fields alone, which the JAX package's config takes; the
    DeepSeek-V2 block's adds the fields it sets, and both round-trip."""
    from mars5_tts_tpu.models.ar import CodecLMConfig as JaxConfig
    from mars5_tts_torch.models.ar import CodecLMConfig

    mars5 = CodecLMConfig.mars5(1283)
    assert JaxConfig(**mars5.to_dict()) == JaxConfig(n_vocab=1283)
    assert CodecLMConfig(**mars5.to_dict()) == mars5
    dsv2 = _cfg()
    assert {"attention", "kv_lora_rank", "n_routed_experts"} <= set(dsv2.to_dict())
    assert "rope_beta_fast" not in dsv2.to_dict()          # at its default
    assert CodecLMConfig(**dsv2.to_dict()) == dsv2
