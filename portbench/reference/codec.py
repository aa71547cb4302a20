"""Encodec's 24 kHz encoder with its residual VQ, and the Vocos vocoder
(charactr/vocos-encodec-24khz), in float32.

The encoder: SEANet with encodec's causal reflect padding (frozen copy of
``mars5_tts_torch/models/encodec.py:64-81``), a two-layer LSTM with a
residual skip, the final conv, then eight stages of nearest-neighbour
quantization of the residual. Vocos: summed codebook embeddings, a k7
conv, AdaLayerNorm, ConvNeXt blocks, LayerNorm, a Linear to log-magnitude
and phase, and the inverse STFT with "same" padding (frozen copy of
``models/vocos.py:107-128``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from .layers import layer_norm


def causal_pad(x, kernel: int, stride: int):
    length = x.shape[-1]
    padding_total = kernel - stride
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    extra = max(ideal - length, 0)
    if padding_total == 0 and extra == 0:
        return x
    max_pad = max(padding_total, extra)
    if length <= max_pad:
        ext = max_pad - length + 1
        return F.pad(F.pad(x, (0, ext)), (padding_total, extra), mode="reflect")[..., :-ext]
    return F.pad(x, (padding_total, extra), mode="reflect")


def _conv(p, pre, x, stride=1):
    w = p[pre + ".weight"]
    return F.conv1d(causal_pad(x, w.shape[-1], stride), w, p[pre + ".bias"], stride=stride)


def encodec_codes(p, cfg, audio):
    """(T,) float audio -> (n_q, frames) codes."""
    x = _conv(p, "init", audio.reshape(1, 1, -1))
    for i, r in enumerate(reversed(cfg["ratios"])):
        pre = f"stages.{i}."
        h = _conv(p, pre + "res.conv2", F.elu(_conv(p, pre + "res.conv1", F.elu(x))))
        x = _conv(p, pre + "down", F.elu(_conv(p, pre + "res.shortcut", x) + h), stride=r)
    d = x.shape[1]
    lstm = torch.nn.LSTM(d, d, num_layers=cfg["lstm_layers"]).to(x.device)
    lstm.load_state_dict({k[5:]: v for k, v in p.items() if k.startswith("lstm.")})
    h = x.permute(2, 0, 1)
    with torch.no_grad():
        h = lstm(h)[0] + h
    emb = _conv(p, "final", F.elu(h.permute(1, 2, 0)))
    residual = emb[0].t()
    codes = []
    for e in p["codebooks"]:
        idx = torch.argmax(2.0 * residual @ e.t() - (e * e).sum(dim=-1), dim=-1)
        residual = residual - e[idx]
        codes.append(idx)
    return torch.stack(codes)


def _ada(p, pre, x, cond):
    return layer_norm(x, eps=1e-6) * p[pre + "scale"][cond] + p[pre + "shift"][cond]


def istft_same(spec, n_fft: int, hop: int, window):
    pad = (n_fft - hop) // 2
    frames = torch.fft.irfft(spec, n=n_fft, dim=1) * window[None, :, None]
    b, _, t = frames.shape
    r = -(-n_fft // hop)
    extra = r * hop - n_fft
    frames = F.pad(frames, (0, 0, 0, extra))
    w2 = F.pad(window * window, (0, extra)).reshape(r, hop)
    chunks = frames.new_zeros((b, t + r - 1, hop))
    env = frames.new_zeros((t + r - 1, hop))
    for s in range(r):
        chunks[:, s:s + t] += frames[:, s * hop:(s + 1) * hop].transpose(1, 2)
        env[s:s + t] += w2[s][None]
    out_len = (t - 1) * hop + n_fft
    audio = chunks.reshape(b, -1)[:, :out_len] / torch.clamp(env.reshape(-1)[:out_len],
                                                            min=1e-11)[None]
    return audio[:, pad:out_len - pad]


def vocos_audio(p, cfg, grid, bandwidth_id: int = 1):
    """(B, T, 8) code grids -> (B, samples) audio."""
    k, bins = cfg["n_codebooks"], cfg["codebook_size"]
    offsets = torch.arange(k, device=grid.device) * bins
    idx = (grid + offsets).clamp(max=p["codebook_weights"].shape[0] - 1)
    feats = p["codebook_weights"][idx].sum(dim=2).transpose(1, 2)       # (B, C, T)
    x = F.conv1d(feats, p["embed.weight"], p["embed.bias"], padding=3)
    x = _ada(p, "norm.", x.transpose(1, 2), bandwidth_id).transpose(1, 2)
    for i in range(cfg["num_layers"]):
        pre = f"convnext.{i}."
        h = F.conv1d(x, p[pre + "dwconv.weight"], p[pre + "dwconv.bias"], padding=3,
                     groups=x.shape[1])
        h = _ada(p, pre + "norm.", h.transpose(1, 2), bandwidth_id)
        h = F.gelu(h @ p[pre + "pwconv1.weight"].t() + p[pre + "pwconv1.bias"])
        h = h @ p[pre + "pwconv2.weight"].t() + p[pre + "pwconv2.bias"]
        x = x + (p[pre + "gamma"] * h).transpose(1, 2)
    x = layer_norm(x.transpose(1, 2), p["final_layer_norm.weight"], p["final_layer_norm.bias"],
                   eps=1e-6)
    mag, phase = (x @ p["out.weight"].t() + p["out.bias"]).transpose(1, 2).chunk(2, dim=1)
    mag = torch.exp(torch.clamp(mag, max=1e2))
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    window = torch.from_numpy(np.hanning(cfg["n_fft"] + 1)[:-1].astype(np.float32)).to(grid.device)
    return istft_same(spec, cfg["n_fft"], cfg["hop_length"], window)
