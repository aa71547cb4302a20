"""End-to-end drive of the public ``Mars5TTS`` API on tiny seeded models.

    python3 mars5_tts_torch/tools/e2e_tiny.py [--device cpu]

Builds a tiny AR, NAR, Encodec and Vocos with seeded random weights beside
byte-level text and merge-free speech tokenizers (no checkpoint, no
download), hands them to ``Mars5TTS.from_params``, synthesizes a shallow
and a deep clone of a 1/30 s tone, and prints each one's codes, samples
and stage seconds. On the card unless ``--device`` says otherwise. The
tiny models make no speech: this checks that every stage runs, not what it
says.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def tiny_tts(device=None):
    """A ``Mars5TTS`` over the tiny geometry of the port's CPU tests (AR dim
    64, 2 heads of 64, 2 layers; NAR dim 64, 4 heads, 2 + 2 layers; Encodec
    and Vocos with 8 codebooks of 1024) with weights drawn from seed 0."""
    import torch

    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.encodec import EncodecConfig, EncodecEncoder
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.vocos import Vocos, VocosConfig
    from mars5_tts_torch.pipeline import resolve_device
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.train("dummy corpus", 256)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.train(" ".join(str(i % 7) for i in range(50)), 1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(CodecLMConfig(n_vocab=258 + 1025, dim=64, n_heads=2, n_kv_heads=2,
                                   head_dim=64, n_layers=2, hidden_dim=96, sliding_window=3000,
                                   n_spk_layers=2, spk_hidden_dim=192)).init_(g)
        nar = ResidualTransformer(ResidualTransformerConfig(
            n_text_vocab=259, dim=64, nhead=4, enc_layers=2, dec_layers=2, n_spk_layers=2,
            t_emb_dim=64, hidden_dim=192)).init_(g)
        enc = EncodecEncoder(EncodecConfig(dimension=16, n_filters=4, ratios=(4, 2), n_q=8,
                                           codebook_size=1024)).init_(g)
        voc = Vocos(VocosConfig(input_channels=16, dim=16, intermediate_dim=32, num_layers=2,
                                n_fft=64, hop_length=16, n_codebooks=8,
                                codebook_size=1024)).init_(g)
    return Mars5TTS.from_params(ar, nar, texttok=texttok, speechtok=speechtok, encodec=enc,
                                vocos=voc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np

    from mars5_tts_torch.config import InferenceConfig

    tts = tiny_tts(args.device)
    tts.default_T = 8
    t = np.arange(800) / 24000
    ref = (0.4 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    for label, text, transcript, deep, cap in (("shallow", "hello world", "", False, 160),
                                               ("deep", "deep clone test", "a ref", True, 260)):
        cfg = InferenceConfig(deep_clone=deep, generate_max_len_override=cap, timesteps=8,
                              trim_db=200)
        codes, audio = tts.tts(text, ref, ref_transcript=transcript, cfg=cfg)
        if not np.isfinite(audio).all():
            raise RuntimeError(f"{label}: non-finite audio")
        timing = tts.last_timing
        print(f"{label}: {len(codes)} AR codes, {len(audio)} samples "
              f"({len(audio) / tts.sr:.2f} s) on {tts.device}; stages (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in timing["stages_s"].items())
              + f"; RTF {timing['rtf']:.2f} (tiny models, not a speed)", flush=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
