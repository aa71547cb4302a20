"""Seeded weights in a few large draws on the device, and the port's modules
and stand-in tokenizers built around them.

``make_state`` draws every leaf of one model from two calls (one normal, one
uniform) of a ``torch.Generator`` on the device, in the distributions of the
port's seeded ``init_`` (``mars5_tts_torch/models/layers.init_params_``,
``models/encodec.EncodecEncoder.init_``, ``models/vocos.Vocos.init_``), and
casts each leaf to the type it is served in (bf16 for the AR and the NAR, f32
for Encodec and Vocos). The same seed gives the same state dicts, so the
plain reference regenerates them after the window instead of holding a copy.

``build_program`` is the construction of ``chip_smoke.build_models``
(``chip_smoke.py:1409-1439``: the released widths, byte-level text and
merge-free speech tokenizers), with the port's modules made on the meta
device and loaded from ``make_state``'s dicts.
"""

from __future__ import annotations

import numpy as np
import torch

# (name prefixes of N(0, 1) tables) per model, as the port's init_ names them
EMBEDDINGS = {
    "ar": ("embed.", "ref_chunked_emb.", "spk_identity_emb."),
    "nar": ("text_embed.", "ref_embedder.", "residual_encoder.", "spk_identity_emb."),
}
MODELS = ("ar", "nar", "encodec", "vocos")


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed of stream ``k`` of run seed ``seed`` (any size)."""
    return int(np.random.SeedSequence([int(seed) % 2**128, k]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _init_kind(model: str, name: str, shape, cfg: dict) -> tuple[str, float, float]:
    """(kind, scale, fill) of a leaf: kind "normal" or "uniform" draws scaled
    by ``scale``; "fill" is the constant ``fill``."""
    leaf = name.rsplit(".", 1)[-1]
    if model in EMBEDDINGS:
        if any(name.startswith(e) for e in EMBEDDINGS[model]):
            return "normal", 1.0, 0.0
        if leaf == "alpha" or (leaf == "weight" and len(shape) == 1):
            return "fill", 0.0, 1.0
        if leaf == "bias" or leaf.endswith("_bias"):
            return "fill", 0.0, 0.0
        return "uniform", shape[-1] ** -0.5, 0.0
    if model == "encodec":
        if name.endswith("bias") or name.startswith("lstm.bias"):
            return "fill", 0.0, 0.0
        if name.startswith("lstm."):
            return "normal", 0.05, 0.0
        if name == "codebooks":
            return "normal", 1.0, 0.0
        return "normal", (shape[1] * shape[2]) ** -0.5, 0.0
    # vocos
    if name == "codebook_weights":
        return "normal", 1.0, 0.0
    if name.endswith("gamma"):
        return "fill", 0.0, 1.0 / cfg["vocos"]["num_layers"]
    if ".norm.scale" in name or name == "norm.scale" or name == "final_layer_norm.weight":
        return "fill", 0.0, 1.0
    if name.endswith("bias") or name.endswith("shift"):
        return "fill", 0.0, 0.0
    if name.endswith("dwconv.weight"):
        return "normal", 0.2, 0.0
    if name == "embed.weight":
        return "normal", 0.1, 0.0
    return "normal", shape[1] ** -0.5, 0.0


def spec(model: str, cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every persistent leaf of one model at ``cfg``'s widths,
    in the port's state-dict order (read from its module on the meta
    device)."""
    with torch.device("meta"):
        module = _module(model, cfg)
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def _module(model: str, cfg: dict):
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.encodec import EncodecConfig, EncodecEncoder
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import Vocos, VocosConfig

    c = cfg[model]
    if model == "ar":
        return CodecLM(CodecLMConfig(**c))
    if model == "nar":
        return ResidualTransformer(ResidualTransformerConfig(**c))
    if model == "encodec":
        return EncodecEncoder(EncodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                               for k, v in c.items()}))
    return Vocos(VocosConfig(**c))


def make_state(model: str, cfg: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} of one model, drawn from ``seed`` on ``device`` in two
    calls, each leaf cast to ``dtype``."""
    leaves = [(n, s, *_init_kind(model, n, s, cfg)) for n, s in spec(model, cfg)]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, MODELS.index(model)))
    pools = {}
    for kind in ("normal", "uniform"):
        total = sum(int(np.prod(s)) for _, s, k, _, _ in leaves if k == kind)
        buf = torch.empty(total, device=device)
        if kind == "normal":
            buf.normal_(generator=gen)
        else:
            buf.uniform_(-1.0, 1.0, generator=gen)
        pools[kind] = buf
    out, offs = {}, {"normal": 0, "uniform": 0}
    for name, shape, kind, scale, fill in leaves:
        n = int(np.prod(shape))
        if kind == "fill":
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
            continue
        v = pools[kind][offs[kind]:offs[kind] + n].view(shape)
        offs[kind] += n
        out[name] = (v * scale).to(dtype)
    return out


def stand_in_tokenizers():
    """The byte-level text and merge-free speech tokenizers of
    ``chip_smoke.build_models`` (258 and 1,025 ids)."""
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})
    return texttok, speechtok


DTYPES = {"ar": torch.bfloat16, "nar": torch.bfloat16, "encodec": torch.float32,
          "vocos": torch.float32}


def states(cfg: dict, seed: int, device) -> dict:
    """The four models' state dicts of run ``seed``."""
    return {m: make_state(m, cfg, seed, device, DTYPES[m]) for m in MODELS}


def build_program(cfg: dict, seed: int, device):
    """(the port's ``Mars5TTS`` built through ``from_params`` with the
    configuration's options, the tokenizers). The AR and NAR are made on the
    meta device and take their weights from ``make_state``."""
    from mars5_tts_torch import Mars5TTS

    sds = states(cfg, seed, device)
    mods = {}
    for m in MODELS:
        if m in ("ar", "nar"):
            with torch.device("meta"):
                mod = _module(m, cfg).to(DTYPES[m])
            mod = mod.to_empty(device=device)
        else:
            with torch.device(device):
                mod = _module(m, cfg)
        mod.load_state_dict(sds.pop(m), strict=True)
        mods[m] = mod
    texttok, speechtok = stand_in_tokenizers()
    opts = dict(cfg["options"])
    if "guidance_interval" in opts:
        opts["guidance_interval"] = tuple(opts["guidance_interval"])
    if "nar_sites" in opts:
        opts["nar_sites"] = tuple(opts["nar_sites"])
    tts = Mars5TTS.from_params(mods["ar"], mods["nar"], texttok=texttok, speechtok=speechtok,
                               encodec=mods["encodec"], vocos=mods["vocos"],
                               device=torch.device(device), **opts)
    return tts
