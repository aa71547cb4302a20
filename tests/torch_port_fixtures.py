"""Shared tiny models for the cross-package tests of ``mars5_tts_torch``.

Everything is built by the JAX package (``init_codeclm`` / ``init_nar`` /
``init_encodec`` / ``init_vocos``) from fixed seeds, then carried into the
port, so each test feeds the same weights and inputs to both packages.
Besides them, ``Forcing``: an AR engine wrapper that makes chosen rows draw
EOS (or no finite logprob) at chosen steps, for the decode-loop tests on
the CPU and on the card.
"""

from __future__ import annotations

import functools
import os

import numpy as np


def make_tokenizers():
    """Byte-level text tokenizer and merge-free speech tokenizer, with the
    reference's special tokens; returns (texttok, speechtok, text_str,
    speech_str) where the strings are the minbpe model files."""
    import tempfile

    from mars5_tts_tpu.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})
    with tempfile.TemporaryDirectory() as d:
        texttok.save(os.path.join(d, "text"))
        speechtok.save(os.path.join(d, "speech"))
        with open(os.path.join(d, "text.model")) as f:
            text_str = f.read()
        with open(os.path.join(d, "speech.model")) as f:
            speech_str = f.read()
    return texttok, speechtok, text_str, speech_str


@functools.lru_cache(maxsize=None)
def tiny_models(seed: int = 0):
    """JAX configs and f32 params of the tiny pipeline geometry (the
    tokenizers' 258 text + 1025 speech ids; AR dim 64 / 2 heads / 2 layers,
    NAR dim 64 / 4 heads / 2+2 layers, small Encodec and Vocos)."""
    import jax

    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm
    from mars5_tts_tpu.models.encodec import EncodecConfig, init_encodec
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar
    from mars5_tts_tpu.models.vocos import VocosConfig, init_vocos

    n_vocab = 258 + 1025
    ar_cfg = CodecLMConfig(n_vocab=n_vocab, dim=64, n_heads=2, n_kv_heads=2,
                           head_dim=64, n_layers=2, hidden_dim=96,
                           sliding_window=3000, n_spk_layers=2, spk_hidden_dim=192)
    nar_cfg = ResidualTransformerConfig(n_text_vocab=259, n_quant=1025, dim=64,
                                        nhead=4, enc_layers=2, dec_layers=2,
                                        n_spk_layers=2, t_emb_dim=64, hidden_dim=192)
    enc_cfg = EncodecConfig(dimension=16, n_filters=4, ratios=(4, 2), n_q=8,
                            codebook_size=1024)
    voc_cfg = VocosConfig(input_channels=16, dim=16, intermediate_dim=32,
                          num_layers=2, n_fft=64, hop_length=16, n_codebooks=8,
                          codebook_size=1024)
    key = jax.random.PRNGKey(seed)
    to_np = functools.partial(jax.tree.map, np.asarray)
    params = {
        "ar": to_np(init_codeclm(key, ar_cfg)),
        "nar": to_np(init_nar(jax.random.fold_in(key, 1), nar_cfg)),
        "encodec": to_np(init_encodec(jax.random.fold_in(key, 2), enc_cfg)),
        "vocos": to_np(init_vocos(jax.random.fold_in(key, 3), voc_cfg)),
    }
    cfgs = {"ar": ar_cfg, "nar": nar_cfg, "encodec": enc_cfg, "vocos": voc_cfg}
    return cfgs, params


@functools.lru_cache(maxsize=None)
def fused_ar(seed: int = 0):
    """JAX config and f32 params of an AR the quantized decode engines take
    (dim 256 = 4 heads x 64, hidden 1024, 2 layers) beside ``tiny_models``'
    tokenizer vocabulary."""
    import jax

    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm

    cfg = CodecLMConfig(n_vocab=258 + 1025, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=2, hidden_dim=1024, sliding_window=3000, n_spk_layers=2,
                        spk_hidden_dim=768)
    return cfg, jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(seed), cfg))


def port_config(jax_cfg, port_cls):
    """The port's config dataclass with the same field values."""
    import dataclasses
    return port_cls(**dataclasses.asdict(jax_cfg))


def port_codeclm(jax_cfg, params):
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.convert import codeclm_reference_state_dict, load_codeclm

    cfg = port_config(jax_cfg, CodecLMConfig)
    return load_codeclm(codeclm_reference_state_dict(params, cfg), cfg)


def port_nar(jax_cfg, params):
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfg = port_config(jax_cfg, ResidualTransformerConfig)
    return load_nar(nar_reference_state_dict(params, cfg), cfg)


def write_checkpoints(tmpdir, seed: int = 0):
    """Reference-layout safetensors AR/NAR checkpoints of ``tiny_models``
    (tokenizers and configs in the metadata). Returns (ar_path, nar_path)."""
    import dataclasses

    from mars5_tts_tpu.hub import save_checkpoint
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.convert import (codeclm_reference_state_dict,
                                                nar_reference_state_dict)
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfgs, params = tiny_models(seed)
    _, _, text_str, speech_str = make_tokenizers()
    vocab = {"texttok.model": text_str, "speechtok.model": speech_str}
    ar_cfg = port_config(cfgs["ar"], CodecLMConfig)
    nar_cfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    ar_path = os.path.join(str(tmpdir), "mars5_ar.safetensors")
    nar_path = os.path.join(str(tmpdir), "mars5_nar.safetensors")
    save_checkpoint(ar_path, codeclm_reference_state_dict(params["ar"], ar_cfg), vocab,
                    config=ar_cfg.to_dict())
    save_checkpoint(nar_path, nar_reference_state_dict(params["nar"], nar_cfg), vocab,
                    config=dataclasses.asdict(nar_cfg))
    return ar_path, nar_path




def write_port_files(tmpdir, fused: bool = False, seed: int = 0) -> dict:
    """Files written by the port alone (``mars5_tts_torch.hub`` and
    ``audio.io``): safetensors AR and NAR checkpoints of ``tiny_models`` (the
    AR of ``fused_ar`` with ``fused``, which the quantized AR backends take),
    the Encodec and Vocos pytrees as ``.npz``, and an 800-sample reference WAV.
    Returns their paths by name ("ar", "nar", "encodec", "vocos", "ref")."""
    import dataclasses

    from mars5_tts_torch.audio.io import write_wav
    from mars5_tts_torch.hub import save_checkpoint, save_pytree_npz
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.convert import (codeclm_reference_state_dict,
                                                nar_reference_state_dict)
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfgs, params = tiny_models(seed)
    ar_jcfg, ar_params = fused_ar(seed) if fused else (cfgs["ar"], params["ar"])
    _, _, text_str, speech_str = make_tokenizers()
    vocab = {"texttok.model": text_str, "speechtok.model": speech_str}
    ar_cfg = port_config(ar_jcfg, CodecLMConfig)
    nar_cfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    d = str(tmpdir)
    paths = {name: os.path.join(d, f) for name, f in (
        ("ar", "mars5_ar.safetensors"), ("nar", "mars5_nar.safetensors"),
        ("encodec", "encodec.npz"), ("vocos", "vocos.npz"), ("ref", "ref.wav"))}
    save_checkpoint(paths["ar"], codeclm_reference_state_dict(ar_params, ar_cfg), vocab,
                    config=ar_cfg.to_dict())
    save_checkpoint(paths["nar"], nar_reference_state_dict(params["nar"], nar_cfg), vocab,
                    config=dataclasses.asdict(nar_cfg))
    save_pytree_npz(paths["encodec"], params["encodec"])
    save_pytree_npz(paths["vocos"], params["vocos"])
    ref = np.random.default_rng(seed + 4).standard_normal(800) * 0.1
    write_wav(paths["ref"], ref.astype(np.float32))
    return paths

def adam_first_update(grads: dict, clip_norm: float = 0.0, eps: float = 1e-8) -> dict:
    """AdamW's first update direction from one model's gradients {name: g}:
    g / (|g| + eps) after optax's global-norm clip, in f64."""
    g = {n: np.asarray(v, np.float64) for n, v in grads.items()}
    norm = np.sqrt(sum(float((v * v).sum()) for v in g.values()))
    s = clip_norm / norm if clip_norm and norm >= clip_norm else 1.0
    return {n: v * s / (np.abs(v * s) + eps) for n, v in g.items()}


def assert_adam_step_close(after: dict, ref_after: dict, grads: dict, ref_grads: dict,
                           lr: float, atol: float, clip_norm: float = 0.0):
    """One model's parameters after its first AdamW step against a
    reference run's, each run's gradients given: every entry within
    ``atol + 2 lr |u - u_ref|``, u and u_ref the update each run's own
    gradients give (``adam_first_update``). Where |g| >> eps both are
    sign(g) and the bound is ``atol``; where |g| is within ~100 eps of zero
    the update follows the gradient's last bits, and the bound with it."""
    u, ur = adam_first_update(grads, clip_norm), adam_first_update(ref_grads, clip_norm)
    for n, ref in ref_after.items():
        err = np.abs(np.asarray(after[n], np.float64) - np.asarray(ref, np.float64))
        bound = atol + 2 * lr * np.abs(u[n] - ur[n])
        bad = err > bound
        assert not bad.any(), (f"{n}: {int(bad.sum())} of {err.size} entries past their bound, "
                               f"worst {err[bad].max()} (bound there {bound[bad].max()})")


class Forcing:
    """``engine`` whose routes make row b draw EOS at its generated count
    ``at[b]`` (0: never) and never elsewhere: there its logits put all the
    mass on EOS, elsewhere none. From its generated count ``dead[b]`` on
    (0: never) row b's logits are all -inf. The forcing reads the device
    state alone, as a pipelined step must."""

    def __init__(self, engine, eos: int, at, dead=None):
        import torch

        self.engine, self.eos, self.at = engine, eos, torch.as_tensor(at)
        self.dead = torch.as_tensor(dead if dead is not None else [0] * len(at))

    def fit(self, *a, **kw):
        return self.engine.fit(*a, **kw)

    def cache(self, *a, **kw):
        return self.engine.cache(*a, **kw)

    def step(self, model, cache):
        import torch

        route = self.engine.step(model, cache)
        body = route.body
        at, dead_at = (t.to(model.embed.weight.device) for t in (self.at, self.dead))

        def forced(state):
            logits = body(state)
            n_gen = state.dev.n_gen
            logits[:, self.eos] = torch.where(at == n_gen, 1e4, -1e4)
            dead = (dead_at > 0) & (n_gen >= dead_at)
            return logits.masked_fill(dead[:, None], float("-inf"))

        route.body = forced
        return route
