"""Rotary position embeddings, half-split layout (``mars5_tts_tpu/ops/rope.py``).

The reference rotates interleaved pairs (2i, 2i+1). The port, like the JAX
package, permutes each head's wq/wk rows once at load
(``models/convert.permute_rope_rows``) so those pairs sit at (i, i + D/2):
scores are unchanged and the rotation is two contiguous-slice multiplies.
A DeepSeek-V2 block (``models/ar.py``, ``attention="mla"``) ropes its 64
rope dims at YaRN's frequencies (``yarn_inv_freq``), its checkpoint's
interleaved ``q_pe`` / ``k_pe`` rows permuted the same way.
"""

from __future__ import annotations

import math

import torch

ROPE_THETA = 10000.0        # the rotary base of both AR blocks


def rope_angles(positions, head_dim: int, theta: float = ROPE_THETA):
    """(cos, sin) of shape positions.shape + (head_dim // 2,), f32."""
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / head_dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope_halfsplit(x, cos, sin):
    """Rotate (first half, second half) pairs of the last axis of ``x``.

    x (..., L, H, D) with cos/sin (..., L, D/2), or cos/sin already
    broadcastable to (..., D/2). f32 math, cast back.
    """
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    if x.ndim == cos.ndim + 2:
        cos, sin = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude factor ``0.1 mscale ln(factor) + 1`` (1 for factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float, original: int, beta_fast: float,
               beta_slow: float) -> tuple[int, int]:
    """(low, high): the rotary pairs YaRN ramps between, from the wavelengths
    that turn ``beta_fast`` and ``beta_slow`` times over ``original``
    positions (``floor`` and ``ceil``, clamped to [0, dim - 1])."""
    def pair(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))
    return max(math.floor(pair(beta_fast)), 0), min(math.ceil(pair(beta_slow)), dim - 1)


def yarn_inv_freq(dim: int, theta: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """(dim / 2,) f32 YaRN inverse frequencies: the base frequencies
    ``theta^(-2i/dim)`` below pair ``low``, those over ``factor`` above pair
    ``high``, a linear ramp between (computed in f64, rounded once)."""
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = theta ** (-2 * i / dim)
    low, high = yarn_range(dim, theta, original, beta_fast, beta_slow)
    mask = 1 - ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return (extra / factor * (1 - mask) + extra * mask).float()


def rope_angles_freq(positions, inv_freq):
    """(cos, sin) of shape positions.shape + inv_freq.shape, f32, at the given
    inverse frequencies (``yarn_inv_freq``)."""
    ang = positions.float()[..., None] * inv_freq.to(positions.device)
    return torch.cos(ang), torch.sin(ang)
