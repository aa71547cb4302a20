"""Long-form narration: chunked synthesis with crossfade stitching
(counterpart of ``mars5_tts_tpu/serving/longform.py``).

The AR is capped at about 2000 codes (about 26 s), so a long text is split
into sentence-sized chunks under a character budget, each chunk synthesized
with the same reference (the voice stays the same), its silence trimmed,
and consecutive chunks overlap-added with a short equal-power crossfade
after a gap. ``stream_longform`` yields the audio chunk by chunk, holding
back only the samples the next junction can still change.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..audio.trim import trim
from ..config import InferenceConfig

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?])\s+")


def chunk_text(text: str, max_chars: int = 300) -> list[str]:
    """Split ``text`` on sentence boundaries into chunks of at most
    ``max_chars`` (an over-long sentence is split on commas, then
    hard-wrapped), in text order."""
    if max_chars < 1:
        raise ValueError(f"max_chars must be >= 1, got {max_chars}")
    sentences = [s.strip() for s in _SENTENCE_SPLIT.split(text.strip()) if s.strip()]
    chunks: list[str] = []
    cur = ""
    for s in sentences:
        if len(s) > max_chars:
            # the sentences buffered before it go first
            if cur:
                chunks.append(cur)
                cur = ""
            rebuilt = ""
            for p in (p.strip() for p in s.split(",")):
                if rebuilt and len(rebuilt) + len(p) + 2 > max_chars:
                    chunks.append(rebuilt + ",")
                    rebuilt = p
                else:
                    rebuilt = (rebuilt + ", " + p) if rebuilt else p
            for i in range(0, len(rebuilt), max_chars):
                frag = rebuilt[i:i + max_chars].strip()
                if frag:
                    chunks.append(frag)
            continue
        if cur and len(cur) + len(s) + 1 > max_chars:
            chunks.append(cur)
            cur = s
        else:
            cur = (cur + " " + s) if cur else s
    if cur:
        chunks.append(cur)
    return chunks


def _fade(n: int) -> np.ndarray:
    return np.linspace(0.0, np.pi / 2, n, dtype=np.float32)


def crossfade_concat(segments: list[np.ndarray], sr: int = 24000, fade_ms: float = 20.0,
                     gap_ms: float = 60.0) -> np.ndarray:
    """Concatenate audio segments, each after a ``gap_ms`` silence, its first
    ``fade_ms`` crossfaded (equal power) with the stream's last."""
    if not segments:
        return np.zeros(0, np.float32)
    fade = max(int(sr * fade_ms / 1000), 1)
    gap = np.zeros(int(sr * gap_ms / 1000), np.float32)
    out = segments[0].astype(np.float32)
    for seg in segments[1:]:
        seg = seg.astype(np.float32)
        out = np.concatenate([out, gap])
        n = min(fade, len(out), len(seg))
        if n > 0:
            t = _fade(n)
            out = np.concatenate([out[:-n], out[-n:] * np.cos(t) + seg[:n] * np.sin(t),
                                  seg[n:]])
        else:
            out = np.concatenate([out, seg])
    return out


@dataclass
class LongformResult:
    audio: np.ndarray
    chunks: list[str]
    chunk_audio_seconds: list[float]
    timings: list[dict]


@dataclass
class StreamChunk:
    """One slice of a streaming long-form synthesis: ``pcm`` is playable now,
    and the ``pcm`` of every chunk in order is ``synthesize_longform``'s
    audio for the same chunks."""

    pcm: np.ndarray           # samples safe to play now (may be empty early on)
    index: int                # the text chunk that produced it
    text: str                 # that chunk's text
    audio_seconds: float      # the chunk's trimmed segment, in seconds
    timing: dict              # the chunk's stage timing (``last_timing``)
    final: bool               # the last chunk (the stream flushed)


def synthesize_longform(tts_model, text: str, ref_audio, ref_transcript: Optional[str] = None,
                        cfg: Optional[InferenceConfig] = None, max_chars: int = 300,
                        fade_ms: float = 20.0, gap_ms: float = 60.0,
                        seed: int = 0) -> LongformResult:
    """Narrate ``text`` of any length: ``chunk_text``, one ``tts_model.tts``
    a chunk (chunk i seeded ``seed + i``), each trimmed, then
    ``crossfade_concat``. The other arguments as ``Mars5TTS.tts``."""
    cfg = cfg or InferenceConfig()
    chunks = chunk_text(text, max_chars=max_chars)
    segments, timings, secs = [], [], []
    for i, chunk in enumerate(chunks):
        _, audio = tts_model.tts(chunk, ref_audio, ref_transcript=ref_transcript, cfg=cfg,
                                 seed=seed + i)
        audio, _ = trim(np.asarray(audio), top_db=cfg.trim_db)
        segments.append(audio)
        secs.append(len(audio) / tts_model.sr)
        timings.append(dict(tts_model.last_timing))
    return LongformResult(audio=crossfade_concat(segments, sr=tts_model.sr, fade_ms=fade_ms,
                                                 gap_ms=gap_ms),
                          chunks=chunks, chunk_audio_seconds=secs, timings=timings)


def stream_longform(tts_model, text: str, ref_audio, ref_transcript: Optional[str] = None,
                    cfg: Optional[InferenceConfig] = None, max_chars: int = 300,
                    fade_ms: float = 20.0, gap_ms: float = 60.0, seed: int = 0,
                    first_chunk_chars: Optional[int] = None,
                    first_chunk_timesteps: Optional[int] = None):
    """``synthesize_longform`` as a stream: yields a ``StreamChunk`` a text
    chunk, the last ``min(fade, stream length)`` samples held back until the
    next junction is mixed (or the stream ends), so the concatenated
    ``pcm`` is the stitched audio exactly.

    Time-to-first-audio ramps: ``first_chunk_chars`` re-splits the first
    chunk at that smaller budget (the chunk list then differs from
    ``synthesize_longform``'s), and ``first_chunk_timesteps`` runs the first
    chunk's diffusion at that step count, the rest at ``cfg.timesteps``."""
    cfg = cfg or InferenceConfig()
    chunks = chunk_text(text, max_chars=max_chars)
    if first_chunk_chars is not None and chunks and len(chunks[0]) > first_chunk_chars:
        chunks = chunk_text(chunks[0], max_chars=first_chunk_chars) + chunks[1:]
    sr = tts_model.sr
    fade = max(int(sr * fade_ms / 1000), 1)
    gap = np.zeros(int(sr * gap_ms / 1000), np.float32)
    held = np.zeros(0, np.float32)      # the stream's unemitted tail
    total = 0                           # the stream's length so far
    last = len(chunks) - 1
    for i, chunk in enumerate(chunks):
        chunk_cfg = cfg
        if i == 0 and first_chunk_timesteps is not None:
            chunk_cfg = dataclasses.replace(cfg, timesteps=first_chunk_timesteps)
        _, audio = tts_model.tts(chunk, ref_audio, ref_transcript=ref_transcript,
                                 cfg=chunk_cfg, seed=seed + i)
        seg, _ = trim(np.asarray(audio), top_db=cfg.trim_db)
        seg = seg.astype(np.float32)
        if i == 0:
            cur = seg
            total = len(seg)
        else:
            held = np.concatenate([held, gap])
            total += len(gap)
            n = min(fade, total, len(seg))
            if n > 0:
                t = _fade(n)
                mixed = held[len(held) - n:] * np.cos(t) + seg[:n] * np.sin(t)
                cur = np.concatenate([held[:len(held) - n], mixed, seg[n:]])
            else:
                cur = np.concatenate([held, seg])
            total += len(seg) - n
        # the next junction rewrites at most min(fade, total) trailing samples
        keep = 0 if i == last else min(fade, total)
        emit, held = cur[:len(cur) - keep], cur[len(cur) - keep:]
        yield StreamChunk(pcm=emit, index=i, text=chunk, audio_seconds=len(seg) / sr,
                          timing=dict(tts_model.last_timing), final=i == last)
