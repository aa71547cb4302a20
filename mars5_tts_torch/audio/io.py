"""WAV read/write with the standard library's ``wave`` and numpy
(the port's own copy of ``mars5_tts_tpu/audio/io.py``).

Reads PCM8/16/24/32 WAVs (a 4-byte sample is taken as PCM32), averages the
channels to mono and resamples linearly to the model rate; writes PCM16.
Linear resampling is enough for reference prompts, which the codec
re-encodes anyway.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path, target_sr: int | None = None):
    """Read a WAV file -> (float32 mono array in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        data = ((a[:, 0].astype(np.int32)) | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        data = np.where(data >= 1 << 23, data - (1 << 24), data).astype(np.float32) / (1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    if target_sr is not None and sr != target_sr:
        data = resample_linear(data, sr, target_sr)
        sr = target_sr
    return data, sr


def float_to_pcm16(audio) -> np.ndarray:
    """Float audio in [-1, 1] -> int16 PCM: clip, scale by 32767, truncate.
    The one conversion both ``write_wav`` and the CLI's streamed chunks use,
    so their bytes agree."""
    audio = np.asarray(audio, np.float32)
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def write_wav(path, audio, sr: int = 24000):
    """Write float audio in [-1, 1] as a mono PCM16 WAV."""
    pcm = float_to_pcm16(audio)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_linear(x, sr_in: int, sr_out: int):
    """Linear-interpolation resampling to ``round(len(x) * sr_out / sr_in)``
    samples."""
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x)), x).astype(np.float32)
