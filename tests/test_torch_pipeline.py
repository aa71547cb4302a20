"""Codecs, the whole synthesis chain and the public API of the port, against
the JAX package at tiny geometry.

Encodec codes, AR tokens and diffusion grids are identical; Vocos audio
agrees to atol 1e-4 (f32 sums, FFT and transcendental implementations differ
between the frameworks by a few ulp).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# tiny tensors: intra-op threads cost more than they save, and the test
# workers share the cores
torch.set_num_threads(1)

from tests.torch_port_fixtures import (make_tokenizers, port_codeclm, port_nar,  # noqa: E402
                                       tiny_models, write_checkpoints)

AUDIO_ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ports():
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree

    cfgs, params = tiny_models()
    return (port_codeclm(cfgs["ar"], params["ar"]), port_nar(cfgs["nar"], params["nar"]),
            encodec_from_pytree(params["encodec"]), vocos_from_pytree(params["vocos"]))


@pytest.mark.parametrize("n_samples", [1600, 2001, 5])   # hop multiple, ragged, shorter than a pad
def test_encodec_codes_identical(n_samples):
    from mars5_tts_tpu.models.encodec import encodec_encode

    cfgs, params = tiny_models()
    enc = _ports()[2]
    audio = (np.random.default_rng(n_samples).standard_normal((1, 1, n_samples)) * 0.3
             ).astype(np.float32)
    ref = encodec_encode(params["encodec"], cfgs["encodec"], jnp.asarray(audio))
    got = enc(torch.from_numpy(audio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pcm = np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(
        enc(torch.from_numpy(pcm)).numpy(),
        np.asarray(encodec_encode(params["encodec"], cfgs["encodec"], jnp.asarray(pcm))))


def test_vocos_audio_close():
    from mars5_tts_tpu.models.vocos import vocos_vocode
    from mars5_tts_torch.models.vocos import VocosConfig

    cfgs, params = tiny_models()
    voc = _ports()[3]
    assert voc.cfg == VocosConfig(**{k: getattr(cfgs["vocos"], k)
                                     for k in cfgs["vocos"].__dataclass_fields__})
    tokens = np.random.default_rng(2).integers(0, 1024, (37, 8))
    ref = np.asarray(vocos_vocode(params["vocos"], cfgs["vocos"], jnp.asarray(tokens)))
    got = voc.vocode(torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (37 * 16,)
    np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL)


def test_vocos_pad_code_matches_jax():
    """The pad code 1024, which the diffusion may draw, in codebooks 0 and 7:
    JAX's gather clamps the flat index past the table to its last row, and
    the port does the same (codebook 0's 1024 reads codebook 1's row 0 in
    both)."""
    from mars5_tts_tpu.models.vocos import vocos_vocode

    cfgs, params = tiny_models()
    voc = _ports()[3]
    tokens = np.random.default_rng(4).integers(0, 1024, (9, 8))
    tokens[2, 0] = tokens[5, 7] = tokens[6, 7] = 1024
    vocos = {k: jnp.asarray(v) if k == "codebook_weights" else v
             for k, v in params["vocos"].items()}      # a device array, as the pipeline holds
    ref = np.asarray(vocos_vocode(vocos, cfgs["vocos"], jnp.asarray(tokens)))
    got = voc.vocode(torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL)


def test_stage_chain_identical():
    """bench.py's run_once chain (Encodec -> AR -> NAR -> Vocos) through both
    packages with shared uniforms: same AR tokens and grid, close audio."""
    from mars5_tts_tpu.config import DSH
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_tpu.models import ar_decode as JA
    from mars5_tts_tpu.models.encodec import encodec_encode
    from mars5_tts_tpu.models.vocos import vocos_vocode
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff
    from mars5_tts_torch.models import ar_decode as PA

    cfgs, params = tiny_models()
    ar, nar, enc, voc = _ports()
    rng = np.random.default_rng(0)
    ref_audio = (rng.standard_normal((1, 1, 8 * 70)) * 0.1).astype(np.float32)
    codes_j = np.asarray(encodec_encode(params["encodec"], cfgs["encodec"],
                                        jnp.asarray(ref_audio)))
    codes_p = enc(torch.from_numpy(ref_audio)).numpy()
    np.testing.assert_array_equal(codes_p, codes_j)
    n_prompt = codes_j.shape[-1]

    text_len, n_text, gen = 10, 258, 24
    prompt = np.concatenate([rng.integers(0, n_text, text_len), codes_j[0, 0] + n_text])
    vs, ve = JA.ar_vocab_window(n_text, 1025, cfgs["ar"].n_vocab)
    common = dict(n_phones_gen=10_000, eos_idx=0, valid_start=vs, valid_end=ve,
                  max_len=len(prompt) + gen)
    u = rng.random(common["max_len"]).astype(np.float32)
    tok_j, n_j = JA.ar_generate(params["ar"], cfgs["ar"], prompt, codes_j[0].T,
                                sampling=JA.ArSampling(**common), uniforms=u)
    tok_p, n_p = PA.ar_generate(ar, prompt, codes_p[0].T, sampling=PA.ArSampling(**common),
                                uniforms=u)
    np.testing.assert_array_equal(tok_p, tok_j)
    assert n_j == n_p == gen

    T = 8
    l0 = (tok_j[len(prompt):] - n_text).clip(0, 1023)
    x = np.repeat(l0[None, :, None], 8, axis=2)
    batch = (rng.integers(0, n_text, (1, text_len)), codes_j.transpose(0, 2, 1),
             np.asarray([text_len]), np.asarray([n_prompt]), x, np.zeros((1, gen), bool))
    dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True,
              jump_len=1, jump_n_sample=1, q0_override_steps=2,
              enable_kevin_scaled_inference=True)
    n_steps = len(build_step_plan(T)[0])
    uni = rng.random((n_steps, 2, 1, n_prompt + gen, 8, 1025)).astype(np.float32)
    x_init = rng.integers(0, 1025, x.shape)
    grid_j = np.asarray(j_infer(params["nar"], cfgs["nar"], batch, JDiff(1025, T), T, dsh,
                                uniforms=uni, x_init=x_init))
    grid_p = p_infer(nar, batch, PDiff(1025, T), T, dsh, uniforms=uni, x_init=x_init)
    np.testing.assert_array_equal(grid_p.numpy(), grid_j)

    audio_j = np.asarray(vocos_vocode(params["vocos"], cfgs["vocos"], jnp.asarray(grid_j[0])))
    audio_p = voc.vocode(grid_p[0]).numpy()
    np.testing.assert_allclose(audio_p, audio_j, atol=AUDIO_ATOL)


def test_mars5tts_from_local_tts_is_seeded(tmp_path):
    from mars5_tts_tpu.config import InferenceConfig
    from mars5_tts_torch import Mars5TTS

    cfgs, params = tiny_models()
    ar_path, nar_path = write_checkpoints(tmp_path)
    tts = Mars5TTS.from_local(ar_path, nar_path, encodec_params=params["encodec"],
                              vocos_params=params["vocos"], device="cpu")
    ref = (np.random.default_rng(4).standard_normal(8 * 60) * 0.1).astype(np.float32)
    cfg = InferenceConfig(timesteps=6, generate_max_len_override=320, trim_db=200)
    runs = [tts.tts("hi there", ref, ref_transcript="ok", cfg=cfg, seed=s, max_retries=1)
            for s in (3, 3, 4)]
    codes, audio = runs[0]
    assert codes.ndim == 1 and audio.dtype == np.float32 and np.isfinite(audio).all()
    assert len(audio) > 0 and set(tts.last_timing["stages_s"]) >= {
        "ar_generate", "nar_diffusion", "vocode"}
    np.testing.assert_array_equal(runs[1][0], codes)
    np.testing.assert_array_equal(runs[1][1], audio)
    assert not (np.array_equal(runs[2][0], codes) and np.array_equal(runs[2][1], audio))
    emb = tts.get_speaker_embedding(ref)
    assert emb.shape == (1, cfgs["ar"].dim) and np.isfinite(emb).all()
    shallow = tts.tts("hi", ref, ref_transcript="", cfg=InferenceConfig(
        timesteps=4, generate_max_len_override=40, deep_clone=False), seed=1)
    assert np.isfinite(shallow[1]).all()


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``Mars5TTS`` and ``from_local`` run on the card unless the caller asks
    for the CPU, and raise when PyTorch sees no card; ``from_params`` follows
    its modules' device."""
    import inspect

    from mars5_tts_torch import Mars5TTS, pipeline

    assert inspect.signature(Mars5TTS.__init__).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pipeline.default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.default_device()
    ar_path, nar_path = write_checkpoints(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mars5TTS.from_local(ar_path, nar_path)
    assert Mars5TTS.from_local(ar_path, nar_path, device="cpu").device == torch.device("cpu")
    ar, nar, _, _ = _ports()
    texttok, speechtok, _, _ = make_tokenizers()
    assert Mars5TTS.from_params(ar, nar, texttok=texttok,
                                speechtok=speechtok).device == torch.device("cpu")


def test_from_params_matches_from_local(tmp_path):
    from mars5_tts_tpu.config import InferenceConfig
    from mars5_tts_torch import Mars5TTS

    cfgs, params = tiny_models()
    ar_path, nar_path = write_checkpoints(tmp_path)
    a = Mars5TTS.from_local(ar_path, nar_path, encodec_params=params["encodec"],
                            vocos_params=params["vocos"], device="cpu")
    ar, nar, enc, voc = _ports()
    texttok, speechtok, _, _ = make_tokenizers()
    b = Mars5TTS.from_params(ar, nar, texttok=texttok, speechtok=speechtok, encodec=enc,
                             vocos=voc)
    ref = (np.random.default_rng(5).standard_normal(8 * 50) * 0.1).astype(np.float32)
    cfg = InferenceConfig(timesteps=4, generate_max_len_override=300)
    out_a = a.tts("yo", ref, ref_transcript="a", cfg=cfg, seed=2)
    out_b = b.tts("yo", ref, ref_transcript="a", cfg=cfg, seed=2)
    np.testing.assert_array_equal(out_a[0], out_b[0])
    np.testing.assert_array_equal(out_a[1], out_b[1])


def test_mars5tts_int8_nar_backend(tmp_path):
    """``nar_backend="int8"``: a W8A8 NAR (the bf16 module given to
    ``from_params`` is left as it was), seeded and reproducible synthesis with
    finite audio, and an unknown backend refused."""
    from mars5_tts_tpu.config import InferenceConfig
    from mars5_tts_torch import Mars5TTS

    cfgs, params = tiny_models()
    ar_path, nar_path = write_checkpoints(tmp_path)
    tts = Mars5TTS.from_local(ar_path, nar_path, encodec_params=params["encodec"],
                              vocos_params=params["vocos"], nar_backend="int8", device="cpu")
    assert tts.nar_backend == "int8" and tts.codecnar.is_quantized
    ref = (np.random.default_rng(7).standard_normal(8 * 60) * 0.1).astype(np.float32)
    cfg = InferenceConfig(timesteps=5, generate_max_len_override=320, trim_db=200)
    runs = [tts.tts("hi there", ref, ref_transcript="ok", cfg=cfg, seed=s) for s in (3, 3)]
    codes, audio = runs[0]
    assert len(audio) > 0 and audio.dtype == np.float32 and np.isfinite(audio).all()
    assert 0 <= int(tts.last_grid.min()) and int(tts.last_grid.max()) <= 1024
    np.testing.assert_array_equal(runs[1][0], codes)
    np.testing.assert_array_equal(runs[1][1], audio)

    ar, nar, enc, voc = _ports()
    texttok, speechtok, _, _ = make_tokenizers()
    kw = dict(texttok=texttok, speechtok=speechtok, encodec=enc, vocos=voc)
    q = Mars5TTS.from_params(ar, nar, nar_backend="int8", **kw)
    assert q.codecnar.is_quantized and not nar.is_quantized
    assert Mars5TTS.from_params(ar, q.codecnar, nar_backend="int8", **kw).codecnar is q.codecnar
    for bad in ("int4", "fp8"):
        with pytest.raises(ValueError):
            Mars5TTS.from_params(ar, nar, nar_backend=bad, **kw)
    with pytest.raises(ValueError):
        Mars5TTS.from_params(ar, q.codecnar, nar_backend="bf16", **kw)


_BLOCKED = textwrap.dedent("""
    import dataclasses
    import sys
    sys.modules["jax"] = None
    sys.modules["mars5_tts_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import mars5_tts_torch
    from mars5_tts_torch import InferenceConfig, Mars5TTS
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.encodec import EncodecConfig, EncodecEncoder
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import Vocos, VocosConfig
    from mars5_tts_torch.ops.kernels import (build, decode_attention, decode_layer,
                                             diffusion_tail, head4, mha, nar_fused, nar_mega)
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer
    from mars5_tts_torch.models.ar_decode_fused import FusedCache, fused_step, prepare_fused
    from mars5_tts_torch.ops.quant import quantize_nar
    g = torch.Generator().manual_seed(0)
    ar = CodecLM(CodecLMConfig.tiny(64)).init_(g).eval()
    nar = quantize_nar(ResidualTransformer(ResidualTransformerConfig.tiny()).init_(g).eval())
    with torch.no_grad():
        y = ar(torch.zeros((1, 5), dtype=torch.long),
               spk_codes=torch.zeros((1, 4, 8), dtype=torch.long))
    assert y.shape == (1, 5, 64) and torch.isfinite(y).all()
    with torch.no_grad():
        z = nar(torch.zeros((1, 3), dtype=torch.long), torch.zeros((1, 4, 8), dtype=torch.long),
                torch.tensor([3]), torch.tensor([4]), torch.zeros((1, 6, 8), dtype=torch.long),
                torch.zeros((1, 6), dtype=torch.bool), torch.tensor([2]))
    assert nar.is_quantized and z.shape == (1, 6, 8, 1025) and torch.isfinite(z).all()
    assert not any(m == "jax" or m.startswith(("jax.", "mars5_tts_tpu")) for m in sys.modules
                   if sys.modules[m] is not None)
    print("forward ok")
    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})
    big = ResidualTransformerConfig(259, dim=256, nhead=4, enc_layers=1, dec_layers=1,
                                    n_spk_layers=1, t_emb_dim=64, hidden_dim=256)
    tts = Mars5TTS.from_params(
        CodecLM(dataclasses.replace(CodecLMConfig.tiny(1283), sliding_window=3000)).init_(g).eval(),
        ResidualTransformer(big).init_(g).eval(), texttok=texttok, speechtok=speechtok,
        encodec=EncodecEncoder(EncodecConfig(dimension=16, n_filters=4, ratios=(4, 2))).init_(g),
        vocos=Vocos(VocosConfig(input_channels=16, dim=16, intermediate_dim=32, num_layers=2,
                                n_fft=64, hop_length=16)).init_(g),
        nar_backend="int8", nar_mega=True,
        nar_tail="split")
    ref = (np.random.default_rng(0).standard_normal(8 * 60) * 0.1).astype(np.float32)
    codes, audio = tts.tts("hi", ref, ref_transcript="ok", cfg=InferenceConfig(
        timesteps=3, generate_max_len_override=300, trim_db=200), seed=2)
    assert len(audio) > 0 and np.isfinite(audio).all()
    assert nar_mega.launch_count == diffusion_tail.tail_launch_count == 0
    assert "mars5_tts_tpu" not in {m.split(".")[0] for m in sys.modules
                                   if sys.modules[m] is not None}
    print("pipeline ok")
    refs = [ref, ref[: 8 * 44]]
    outs = tts.tts_batch(["hi", "yo there"], refs, ref_transcript=["ok", "no"],
                         cfg=InferenceConfig(timesteps=2, generate_max_len_override=300,
                                             trim_db=200), seed=3)
    assert len(outs) == 2 and all(len(w) > 0 and np.isfinite(w).all() for _, w in outs)
    assert decode_attention.launch_count == 0 and not build._loaded
    assert "jax" not in {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
    print("tts_batch ok")
    # importing the kernel module built nothing; CPU tensors take the twin
    assert not build._loaded and mha.launch_count == 0
    q = torch.randn(1, 5, 2, 64)
    assert torch.equal(mha.mha(q, q, q), mha.mha_ref(q, q, q))
    assert not build._loaded and mha.launch_count == 0
    assert nar_fused.fused_linear_launches == nar_fused.fused_ffn_launches == 0
    assert diffusion_tail.launch_count == 0
    cfg = CodecLMConfig(n_vocab=64, dim=128, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=1,
                        hidden_dim=256, sliding_window=16)
    fp, dims = prepare_fused(CodecLM(cfg).init_(g).eval(), 20, wbits=4, head4=True)
    logits = fused_step(fp, dims, cfg, 3, 5, FusedCache(dims, "cpu"))
    assert logits.shape == (1, 64) and torch.isfinite(logits).all()
    assert decode_layer.launch_count == head4.launch_count == 0 and not build._loaded
    print("kernel module ok")
    from mars5_tts_torch import data, parallel, train
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.serving import multichip
    corpus = data.synthetic_corpus(4, text_vocab=16)
    ab, nb = next(data.batches(corpus, 2, n_text_vocab_offset=16, eos_idx=63))
    opt = train.make_optimizer(1e-3, clip_norm=1.0)
    state = train.init_train_state(CodecLM(CodecLMConfig.tiny(64)).init_(g),
                                   ResidualTransformer(ResidualTransformerConfig.tiny(16)).init_(g),
                                   opt)
    state, m = train.make_train_step(MultinomialDiffusion(1025, 8), opt)(state, ab, nb)
    assert np.isfinite(float(m["ar_loss"])) and np.isfinite(float(m["nar_loss"]))
    assert "jax" not in {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
    print("train ok")
""")


@pytest.fixture(scope="module")
def blocked_run():
    """The port imported in a fresh process with jax blocked and no nvcc."""
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin",
               CUDA_HOME=os.path.join(REPO, "no-cuda-here"))
    return subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


def test_port_imports_and_runs_with_jax_blocked(blocked_run):
    assert "forward ok" in blocked_run.stdout, blocked_run.stderr
    assert "pipeline ok" in blocked_run.stdout, blocked_run.stderr
    assert "tts_batch ok" in blocked_run.stdout, blocked_run.stderr


def _imported_modules(path):
    import ast

    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_nothing_of_the_jax_package():
    """No file of ``mars5_tts_torch/`` and nothing in ``chip_smoke.py``
    imports ``mars5_tts_tpu`` (or jax), at any place in the file."""
    import glob

    files = glob.glob(os.path.join(REPO, "mars5_tts_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 30
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("mars5_tts_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_training_modules_run_with_jax_blocked(blocked_run):
    """``data``, ``train``, ``parallel`` and ``serving.multichip`` import, and
    a train step runs, with jax and the JAX package blocked."""
    assert "train ok" in blocked_run.stdout, blocked_run.stderr


def test_kernel_module_imports_without_nvcc(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr
    assert "kernel module ok" in blocked_run.stdout
