"""Progressive synthesis within one utterance: audio streams while the NAR
denoises (counterpart of ``mars5_tts_tpu/serving/progressive.py``).

The AR runs first (L0 must exist before any frame is denoised); the
generated frames are then split into segments of ``seg_frames``, each
denoised as a deep-clone continuation of a known prompt, the speaker
reference (``keep_spk_prompt``) and the last ``ctx_frames`` frames already
emitted, and vocoded with a margin. Segment 0 keeps the request's clone mode
(shallow clone conditions on the reference without continuing it); every
later segment continues the emitted frames. Under deep clone the AR's
regenerated prompt span, which ``tts`` crops, is dropped before denoising.
Segment k draws from a generator seeded ``seed + 1 + k``. Each segment
runs the model's own NAR route, guidance interval and buckets
(``Mars5TTS._nar``).

``vocode_margin`` re-vocodes that many frames of left context and holds
back the samples of the last that many frames until the next segment
supplies their right context, so the concatenated ``pcm`` is one vocode of
the emitted grid away from the edges. There is no trim: it needs the
whole waveform.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import InferenceConfig
from ..utils.profiling import StageTimer


@dataclass
class ProgressiveChunk:
    """One emitted segment: ``pcm`` (float32 mono 24 kHz; the last
    ``vocode_margin`` frames' samples held back but on the final chunk),
    the emitted-grid frames [frame_start, frame_end), the segment's (frames,
    8) ``grid``, and the request's cumulative stage report so far."""

    pcm: np.ndarray
    frame_start: int
    frame_end: int
    grid: np.ndarray
    timing: Optional[dict] = None


def _segment_grid(model, text_tokens, prompt_codes, seg_l0, cfg, generator,
                  continuation: bool = True):
    """Denoise one segment: ``prompt_codes`` (P, 8) of acoustic context and
    ``seg_l0`` (S,) AR L0 ids -> the (S, 8) grid. ``continuation`` makes the
    context a known deep-clone prefix; False uses it for speaker
    conditioning only (segment 0 of a shallow-clone request)."""
    c_text = np.asarray(text_tokens, np.int64)[None]
    c_codes = np.asarray(prompt_codes, np.int64)[None]
    x = np.repeat(np.asarray(seg_l0, np.int64)[None, :, None], 8, axis=2)
    batch = (c_text, c_codes, np.asarray([c_text.shape[1]]), np.asarray([c_codes.shape[1]]),
             x, np.zeros((1, x.shape[1]), bool))
    return model._nar(batch, cfg, generator, deep_clone=continuation)[0].cpu().numpy()


@torch.inference_mode()
def stream_tts(model, text: str, ref_audio, ref_transcript: Optional[str] = None,
               cfg: Optional[InferenceConfig] = None, seed: int = 0, seg_frames: int = 192,
               ctx_frames: int = 192, vocode_margin: int = 32, keep_spk_prompt: bool = True):
    """Yield ``ProgressiveChunk``s of one utterance, one a denoised segment;
    ``model`` a ``Mars5TTS``, the other arguments as ``Mars5TTS.tts``."""
    cfg = cfg or InferenceConfig()
    if seg_frames < 1 or ctx_frames < 0 or vocode_margin < 0:
        raise ValueError("seg_frames >= 1, ctx_frames/vocode_margin >= 0")
    if not keep_spk_prompt and ctx_frames == 0:
        # segments past the first would have no acoustic prompt at all
        raise ValueError("keep_spk_prompt=False requires ctx_frames >= 1")
    timer = StageTimer(sync=model._sync)
    text_tokens, prompt_codec, raw_prompt_len, gen_codes = model._synthesize_codes(
        text, ref_audio, ref_transcript, cfg, seed, timer)

    spk_prompt = prompt_codec[0].T.cpu().numpy().astype(np.int64)      # (S, 8)
    l0 = np.asarray(gen_codes, np.int64)[raw_prompt_len if cfg.deep_clone else 0:]
    if l0.size == 0:
        return

    emitted = np.zeros((0, 8), np.int64)
    emitted_pcm = 0                       # samples already yielded
    hop = model.vocos.cfg.hop_length      # samples a codec frame
    starts = list(range(0, len(l0), seg_frames))
    for k, s0 in enumerate(starts):
        seg = l0[s0: s0 + seg_frames]
        with timer.stage(f"nar_seg{k}"):
            parts = []
            if keep_spk_prompt or k == 0:
                parts.append(spk_prompt)
            if ctx_frames and len(emitted):
                parts.append(emitted[-ctx_frames:])
            gen = torch.Generator(device=model.device).manual_seed(seed + 1 + k)
            grid = _segment_grid(model, text_tokens, np.concatenate(parts, axis=0), seg, cfg,
                                 gen, continuation=cfg.deep_clone or k > 0)
        emitted = np.concatenate([emitted, grid], axis=0)
        last = k == len(starts) - 1
        with timer.stage(f"vocode_seg{k}"):
            # left context re-vocoded, right context held back: the vocoder's
            # convolutions are not causal
            v0 = max(0, len(emitted) - len(grid) - 2 * vocode_margin)
            pcm = model.vocode(emitted[v0:])[: (len(emitted) - v0) * hop]
            e1 = len(emitted) if last else max(0, len(emitted) - vocode_margin)
            pcm = pcm[emitted_pcm - v0 * hop: e1 * hop - v0 * hop]
        timing = timer.report(audio_seconds=(emitted_pcm + len(pcm)) / model.sr)
        yield ProgressiveChunk(pcm=pcm, frame_start=s0, frame_end=s0 + len(grid), grid=grid,
                               timing=timing)
        emitted_pcm += len(pcm)


def progressive_tts(model, text: str, ref_audio, ref_transcript: Optional[str] = None,
                    cfg: Optional[InferenceConfig] = None, seed: int = 0, **kw):
    """``stream_tts`` collected: ``(grid (L, 8), audio (T,))``."""
    grids, pcms = [], []
    for chunk in stream_tts(model, text, ref_audio, ref_transcript=ref_transcript, cfg=cfg,
                            seed=seed, **kw):
        grids.append(chunk.grid)
        pcms.append(chunk.pcm)
    if not grids:
        return np.zeros((0, 8), np.int64), np.zeros((0,), np.float32)
    return np.concatenate(grids, axis=0), np.concatenate(pcms)
