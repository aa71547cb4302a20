"""Silence trimming — a numpy port of librosa's ``effects.trim``.

Mirrors the reference's numba-free librosa port (mars5/trim.py:110-740): centered
reflect-padded framing, per-frame RMS power, dB conversion against the peak, and
first/last non-silent frame boundaries. This is host-side DSP on final audio, so
plain numpy is the right tool. The port's own copy of
``mars5_tts_tpu/audio/trim.py``.
"""

from __future__ import annotations

import numpy as np


def frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Overlapping frame view of 1-D ``x``: (frame_length, n_frames)."""
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = (np.arange(frame_length)[:, None]
           + hop_length * np.arange(n_frames)[None, :])
    return x[idx]


def rms(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512,
        center: bool = True, pad_mode: str = "reflect") -> np.ndarray:
    """Per-frame RMS of shape (1, n_frames) (librosa.feature.rms on samples)."""
    y = np.asarray(y)
    if y.ndim > 1:
        y = y.mean(axis=0)
    if center:
        y = np.pad(y, frame_length // 2, mode=pad_mode)
    x = frame(y, frame_length, hop_length)
    power = np.mean(np.abs(x) ** 2, axis=0, keepdims=True)
    return np.sqrt(power)


def power_to_db(S, ref=1.0, amin: float = 1e-10, top_db=80.0) -> np.ndarray:
    """10*log10(S/ref), numerically stabilized; optional top_db floor."""
    S = np.asarray(S)
    ref_value = np.abs(ref(S)) if callable(ref) else np.abs(ref)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec = log_spec - 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def _signal_to_frame_nonsilent(y, frame_length: int, hop_length: int,
                               top_db: float, ref) -> np.ndarray:
    y = np.asarray(y)
    y_mono = y.mean(axis=0) if y.ndim > 1 else y
    mse = rms(y_mono, frame_length=frame_length, hop_length=hop_length) ** 2
    return power_to_db(mse.squeeze(), ref=ref, top_db=None) > -top_db


def frames_to_samples(frames, hop_length: int = 512, n_fft=None):
    offset = int(n_fft // 2) if n_fft is not None else 0
    return (np.asanyarray(frames) * hop_length + offset).astype(int)


def trim(y, top_db: float = 60, ref=np.max, frame_length: int = 2048,
         hop_length: int = 512):
    """Trim leading/trailing silence.

    Args:
        y: (n,) or (channels, n) audio.
    Returns:
        (trimmed audio, np.array([start, end]) sample indices).
    """
    y = np.asarray(y)
    non_silent = _signal_to_frame_nonsilent(
        y, frame_length=frame_length, hop_length=hop_length, top_db=top_db, ref=ref)
    nonzero = np.flatnonzero(non_silent)
    if nonzero.size > 0:
        start = int(frames_to_samples(nonzero[0], hop_length))
        end = min(y.shape[-1], int(frames_to_samples(nonzero[-1] + 1, hop_length)))
    else:
        start, end = 0, 0
    full_index = [slice(None)] * y.ndim
    full_index[-1] = slice(start, end)
    return y[tuple(full_index)], np.asarray([start, end])
