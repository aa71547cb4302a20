"""The port's deploy surfaces at tiny geometry on the CPU, on files the port
wrote: ``mars5_tts_torch/deploy/predict.py`` (``Predictor``,
``deploy_kwargs``) and ``mars5_tts_torch/hubconf.py`` (``mars5_english``).

* One case per environment variable the JAX deployment reads: the
  ``Predictor``'s model takes the route the JAX ``deploy/predict.py`` and
  the JAX pipeline read from the same environment (the JAX predictor's own
  model for the backends, interval and buckets; the JAX package's readers,
  or the expression at the cited line where the reader is inline or runs
  at import, for the route switches).
* ``predict`` writes the WAV of ``Mars5TTS.tts`` with those options, sample
  for sample; no card and no ``device`` raises.
* Malformed ``MARS5_GUIDANCE_INTERVAL`` values raise ValueError naming it.
* ``mars5_english(ar_path=, nar_path=)`` equals ``from_local``; a bad
  ``ckpt_format`` raises; ``torch.hub.load`` on the repository still finds
  the JAX package's root ``hubconf.py``.
"""

import os
import wave

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import write_port_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWITCHES = ("MARS5_AR_BACKEND", "MARS5_NAR_BACKEND", "MARS5_NAR_GEN_BUCKET",
            "MARS5_NAR_TEXT_BUCKET", "MARS5_GUIDANCE_INTERVAL", "MARS5_HEAD4", "MARS5_INT4_MSE",
            "MARS5_SDPA_BF16", "MARS5_CROSS_PALLAS", "MARS5_NAR_FUSED", "MARS5_NARF_SITES",
            "MARS5_NARF_GSIZE", "MARS5_QATTN", "MARS5_NAR_MEGA", "MARS5_FUSED_TAIL",
            "MARS5_FUSED_HEADTAIL")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_port_files(tmp_path_factory.mktemp("deploy"), fused=True)


@pytest.fixture
def env(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _jax_reads(environ):
    """The routes the JAX package takes in an environment, read by its own
    readers where it has them."""
    import mars5_tts_tpu.models.layers as JL
    import mars5_tts_tpu.ops.attention as JA

    ar = environ.get("MARS5_AR_BACKEND", "fused4")
    int8 = environ.get("MARS5_NAR_BACKEND", "int8") == "int8"
    fused = environ.get("MARS5_NAR_FUSED", "1") == "1"               # layers.py:71
    sites, gsize = JL._nar_fused_sites(), JL._nar_fused_gsize()
    return {
        "head4": ar == "fused4" and environ.get("MARS5_HEAD4", "0") == "1",  # ar_decode_fused.py:66
        "int4_mse": environ.get("MARS5_INT4_MSE", "1") == "1",       # pallas/decode_layer.py:621
        "sdpa_bf16": JA._scores_bf16(),
        "cross_k1": environ.get("MARS5_CROSS_PALLAS", "0") == "1",    # attention.py:26
        "qattn": int8 and environ.get("MARS5_QATTN", "0") == "1",     # attention.py:25
        "fused": fused or not int8,
        "sites": sites if int8 else frozenset(("qkv", "caq", "ffn")),
        # pipeline.py:163-165: groups only with the fused layer on
        "gsize": gsize if int8 and fused else 0,
        # layers.py:275; the tiny decoder (head dim 16) does not fit the
        # mega kernel, so JAX's mega_supported keeps the per-layer route
        "mega": False,
        # engine.py:131 and :227
        "tail": ("heads" if not int8 else "dense"
                 if environ.get("MARS5_FUSED_TAIL", "1") != "1" else "heads"
                 if environ.get("MARS5_FUSED_HEADTAIL", "1") == "1" else "split"),
    }


CASES = [{}, {"MARS5_AR_BACKEND": "fused"}, {"MARS5_AR_BACKEND": "bf16"},
         {"MARS5_NAR_BACKEND": "bf16"}, {"MARS5_NAR_GEN_BUCKET": "0"},
         {"MARS5_NAR_TEXT_BUCKET": "16"}, {"MARS5_GUIDANCE_INTERVAL": "0,1"},
         {"MARS5_HEAD4": "1"}, {"MARS5_HEAD4": "1", "MARS5_AR_BACKEND": "fused"},
         {"MARS5_INT4_MSE": "0"}, {"MARS5_SDPA_BF16": "0"}, {"MARS5_CROSS_PALLAS": "1"},
         {"MARS5_NAR_FUSED": "0"}, {"MARS5_NARF_SITES": "ffn,qkv,saout"},
         {"MARS5_NARF_GSIZE": "32"}, {"MARS5_NARF_GSIZE": "32", "MARS5_NAR_FUSED": "0"},
         {"MARS5_QATTN": "1"}, {"MARS5_NAR_MEGA": "1"}, {"MARS5_FUSED_TAIL": "0"},
         {"MARS5_FUSED_HEADTAIL": "0"}, {"MARS5_QATTN": "1", "MARS5_NAR_BACKEND": "bf16"}]


@pytest.mark.parametrize("case", CASES, ids=lambda c: ",".join(f"{k[6:]}={v}" for k, v in
                                                                c.items()) or "defaults")
def test_predictor_takes_the_jax_route(files, env, case):
    from deploy.predict import Predictor as JPredictor
    from mars5_tts_torch.deploy.predict import DTYPE, Predictor

    for k, v in case.items():
        env.setenv(k, v)
    want = _jax_reads(os.environ)
    pred = Predictor()
    pred.setup(files["ar"], files["nar"], files["encodec"], files["vocos"], device="cpu")
    m = pred.model
    o = m.nar_options
    got = {"head4": m.head4, "int4_mse": m.int4_mse, "sdpa_bf16": o.sdpa_bf16,
           "cross_k1": o.cross_k1, "qattn": o.qattn, "fused": o.fused,
           "sites": frozenset(o.sites), "gsize": o.gsize, "mega": m.nar_mega,
           "tail": m.nar_tail}
    assert got == want
    assert m.codeclm.embed.weight.dtype == m.codecnar.text_embed.weight.dtype == DTYPE
    jpred = JPredictor()
    jpred.setup(files["ar"], files["nar"], files["encodec"], files["vocos"])
    j = jpred.model
    assert (m.ar_backend, m.nar_backend, m.guidance_interval, m.nar_gen_bucket,
            m.nar_text_bucket) == (j.ar_backend, j.nar_backend, j.guidance_interval,
                                   j.nar_gen_bucket, j.nar_text_bucket)


def test_deploy_kwargs_map_mega_and_group_scales(env):
    """``MARS5_NAR_MEGA=1`` asks for K9 (the Predictor takes it where the
    decoder fits), with the default sites; not with group scales (JAX's K9
    refuses them) nor with the bf16 NAR."""
    from mars5_tts_torch.deploy.predict import deploy_kwargs

    kw = deploy_kwargs({"MARS5_NAR_MEGA": "1", "MARS5_NARF_SITES": "qkv"})
    assert kw["nar_mega"] and kw["nar_sites"] == ("qkv", "caq", "ffn")
    assert not deploy_kwargs({"MARS5_NAR_MEGA": "1", "MARS5_NARF_GSIZE": "128"})["nar_mega"]
    kw = deploy_kwargs({"MARS5_NAR_MEGA": "1", "MARS5_NAR_BACKEND": "bf16"})
    assert not kw["nar_mega"] and "nar_sites" not in kw
    assert deploy_kwargs({"MARS5_NARF_SITES": " caout , qkv "})["nar_sites"] == ("qkv", "caout")


def test_predict_writes_the_tts_wav(files, env, tmp_path):
    """``predict``'s WAV against ``tts`` with the deploy options and the
    request's configuration. The configuration class is given, in the test
    only, 6 reverse steps and a 200-token AR cap (the deployment's 200 and
    2,000 take minutes at this size on the CPU); both sides take it."""
    import functools

    import mars5_tts_torch.config as PC
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.audio.io import float_to_pcm16, read_wav
    from mars5_tts_torch.deploy.predict import DTYPE, Predictor, deploy_kwargs
    from mars5_tts_torch.hub import load_codec_params

    InferenceConfig = functools.partial(PC.InferenceConfig, timesteps=6,
                                        generate_max_len_override=200)
    env.setattr(PC, "InferenceConfig", InferenceConfig)
    pred = Predictor()
    pred.setup(files["ar"], files["nar"], files["encodec"], files["vocos"], device="cpu")
    out = pred.predict("hi there", files["ref"], "ok", out_path=str(tmp_path / "o.wav"))
    with wave.open(out, "rb") as w:
        got = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    kw = deploy_kwargs(os.environ)
    kw.pop("nar_mega")
    tts = Mars5TTS.from_local(files["ar"], files["nar"], device="cpu", dtype=DTYPE,
                              encodec_params=load_codec_params(files["encodec"], "encodec"),
                              vocos_params=load_codec_params(files["vocos"], "vocos"), **kw)
    cfg = InferenceConfig(deep_clone=True, rep_penalty_window=100, top_k=100, temperature=0.7,
                          freq_penalty=3.0)
    _, audio = tts.tts("hi there", read_wav(files["ref"], 24000)[0], ref_transcript="ok",
                       cfg=cfg)
    assert len(got) > 0
    np.testing.assert_array_equal(got, float_to_pcm16(audio))


def test_predictor_needs_a_card_unless_told(files, env, monkeypatch):
    from mars5_tts_torch.deploy.predict import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor().setup(files["ar"], files["nar"], device=device)


@pytest.mark.parametrize("bad", ["0.5", "0,0.5,1", "0.6,0.2", "0,1.5", "a,b", "-0.1,0.5", ""])
def test_malformed_guidance_interval_raises(files, env, bad):
    from mars5_tts_torch.deploy.predict import Predictor, guidance_interval

    with pytest.raises(ValueError, match="MARS5_GUIDANCE_INTERVAL"):
        guidance_interval({"MARS5_GUIDANCE_INTERVAL": bad})
    env.setenv("MARS5_GUIDANCE_INTERVAL", bad)
    with pytest.raises(ValueError, match="MARS5_GUIDANCE_INTERVAL"):
        Predictor().setup(files["ar"], files["nar"], device="cpu")


def test_guidance_interval_accepts_the_bounds():
    from mars5_tts_torch.deploy.predict import guidance_interval

    assert guidance_interval({}) == (0.0, 0.5)
    assert guidance_interval({"MARS5_GUIDANCE_INTERVAL": "0,1"}) == (0.0, 1.0)
    assert guidance_interval({"MARS5_GUIDANCE_INTERVAL": " 0.25 , 0.75 "}) == (0.25, 0.75)


def test_mars5_english_equals_from_local(files):
    from mars5_tts_torch import InferenceConfig, Mars5TTS
    from mars5_tts_torch.hub import load_codec_params
    from mars5_tts_torch.hubconf import mars5_english

    codecs = {"encodec_params": load_codec_params(files["encodec"], "encodec"),
              "vocos_params": load_codec_params(files["vocos"], "vocos")}
    model, config_class = mars5_english(ar_path=files["ar"], nar_path=files["nar"],
                                        device="cpu", **codecs)
    assert config_class is InferenceConfig and model.device == torch.device("cpu")
    ref = Mars5TTS.from_local(files["ar"], files["nar"], device="cpu", **codecs)
    audio = np.random.default_rng(2).standard_normal(800).astype(np.float32) * 0.1
    cfg = InferenceConfig(timesteps=4, generate_max_len_override=200, trim_db=200)
    a, b = (m.tts("yo", audio, ref_transcript="a", cfg=cfg, seed=1) for m in (model, ref))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="ckpt_format"):
        mars5_english(ckpt_format="onnx", ar_path=files["ar"], nar_path=files["nar"],
                      device="cpu")


def test_torch_hub_finds_the_jax_hubconf(files):
    import mars5_tts_tpu.pipeline as JP

    model, _ = torch.hub.load(REPO, "mars5_english", source="local", ar_path=files["ar"],
                              nar_path=files["nar"])
    assert isinstance(model, JP.Mars5TTS)
