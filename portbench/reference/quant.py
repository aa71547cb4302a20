"""Quantizers, frozen copies of the port's arithmetic, returning dequantized
float32 tensors (the reference computes ``q * s`` products in float32).

``levels`` is 127 for int8 and 7 for int4 (the control's precision).
"""

from __future__ import annotations

import torch


def _div(t, c: float):
    """One rounded division (``mars5_tts_torch/ops/quant.py:83-88``)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def rows(w, levels: int = 127):
    """Per-row symmetric quantization over the input axis, dequantized
    (``ops/quant.py:90-96``, ``quantize_weight``)."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=-1, keepdim=True), levels)
    q = torch.round(wf / scale.clamp_min(1e-12)).clamp(-levels, levels)
    return q * scale


def rows_mse(w, levels: int, ratios=(1.0, 0.9, 0.8, 0.7, 0.6)):
    """Per-row quantization with the clip search, dequantized
    (``ops/quant.py:99-118``, ``quantize_weight_mse``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    best_err = best_scale = None
    for r in ratios:
        scale = (amax * (r / levels)).clamp_min(1e-12)
        q = torch.round(wf / scale).clamp(-levels, levels)
        err = (q * scale - wf).square().sum(dim=-1, keepdim=True)
        if best_err is None:
            best_err, best_scale = err, scale
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_scale = torch.where(take, scale, best_scale)
    return torch.round(wf / best_scale).clamp(-levels, levels) * best_scale


def int4(w, mse: bool = True):
    """Per-row int4 (``ops/kernels/decode_layer.py:152-154``, ``_int4``)."""
    return rows_mse(w, 7) if mse else rows(w, 7)


def int4_halves(w, mse: bool = True):
    """Each half of the input axis quantized on its own, as the K2 pack packs
    its nibbles (``decode_layer.py:157-163``, ``_q4``)."""
    h = w.shape[-1] // 2
    return torch.cat([int4(w[:, :h], mse), int4(w[:, h:], mse)], dim=-1)


def act(x, levels: int = 127):
    """Dynamic per-row quantization of activations, dequantized
    (``ops/quant.py:146-150``, ``quantize_act``)."""
    xf = x.float()
    xs = _div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), levels)
    return torch.round(xf / xs).clamp(-levels, levels) * xs
