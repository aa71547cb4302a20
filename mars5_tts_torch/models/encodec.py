"""Encodec 24 kHz encoder and 8-stage residual VQ
(counterpart of ``mars5_tts_tpu/models/encodec.py``).

SEANet encoder with encodec's exact causal padding (reflect on both sides,
the right side covering the last partial frame), a 2-layer LSTM with a
residual skip, and nearest-neighbour RVQ as ``argmax(2 x.e - |e|^2)`` in f32.
Weights come from a parameter pytree of numpy leaves (the JAX package's
layout) through ``encodec_from_pytree``, or from a seeded ``init_``;
``convert_encodec`` makes that pytree from an official ``encodec_24khz``
state dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class EncodecConfig:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    ratios: tuple = (8, 5, 4, 2)      # decoder order; the encoder runs them reversed
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    compress: int = 2
    lstm_layers: int = 2
    n_q: int = 8
    codebook_size: int = 1024
    sample_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    @classmethod
    def mars5(cls) -> "EncodecConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EncodecConfig":
        return cls(dimension=16, n_filters=4, ratios=(4, 2), n_q=4, codebook_size=32)

    @classmethod
    def infer(cls, params) -> "EncodecConfig":
        """The config implied by a parameter pytree's shapes."""
        ratios = tuple(int(np.shape(s["down"]["w"])[-1]) // 2 for s in params["stages"])
        n_q, codebook_size, _ = np.shape(params["codebooks"])
        return cls(dimension=int(np.shape(params["final"]["w"])[0]),
                   n_filters=int(np.shape(params["init"]["w"])[0]),
                   ratios=ratios[::-1], kernel_size=int(np.shape(params["init"]["w"])[-1]),
                   last_kernel_size=int(np.shape(params["final"]["w"])[-1]),
                   lstm_layers=len(params["lstm"]["layers"]), n_q=int(n_q),
                   codebook_size=int(codebook_size))


def causal_pad(x, kernel: int, stride: int, dilation: int):
    """encodec's SConv1d padding: ``eff_k - stride`` on the left and the
    extra right padding that completes the last frame, both reflect; inputs
    shorter than the pad are zero-extended first and the extension cropped."""
    length = x.shape[-1]
    eff_k = (kernel - 1) * dilation + 1
    padding_total = eff_k - stride
    n_frames = (length - eff_k + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (eff_k - padding_total)
    extra_padding = max(ideal_length - length, 0)
    max_pad = max(padding_total, extra_padding)
    if padding_total == 0 and extra_padding == 0:
        return x
    if length <= max_pad:
        ext = max_pad - length + 1
        x = F.pad(x, (0, ext))
        return F.pad(x, (padding_total, extra_padding), mode="reflect")[..., :-ext]
    return F.pad(x, (padding_total, extra_padding), mode="reflect")


class SConv1d(nn.Module):
    """Causally padded conv; weight norm already folded into ``weight``."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, kernel))
        self.bias = nn.Parameter(torch.zeros(out_c))

    def forward(self, x):
        x = causal_pad(x, self.weight.shape[-1], self.stride, 1)
        return F.conv1d(x, self.weight, self.bias, stride=self.stride)


class ResBlock(nn.Module):
    def __init__(self, dim: int, cfg: EncodecConfig):
        super().__init__()
        self.conv1 = SConv1d(dim, dim // cfg.compress, cfg.residual_kernel_size)
        self.conv2 = SConv1d(dim // cfg.compress, dim, 1)
        self.shortcut = SConv1d(dim, dim, 1)

    def forward(self, x):
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return self.shortcut(x) + h


class Stage(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: EncodecConfig):
        super().__init__()
        self.res = ResBlock(dim, cfg)
        self.down = SConv1d(dim, 2 * dim, 2 * ratio, stride=ratio)

    def forward(self, x):
        return self.down(F.elu(self.res(x)))


class EncodecEncoder(nn.Module):
    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        nf = cfg.n_filters
        self.init = SConv1d(cfg.channels, nf, cfg.kernel_size)
        dims = [nf * 2 ** i for i in range(len(cfg.ratios))]
        self.stages = nn.ModuleList(Stage(d, r, cfg)
                                    for d, r in zip(dims, reversed(cfg.ratios)))
        d = nf * 2 ** len(cfg.ratios)
        self.lstm = nn.LSTM(d, d, num_layers=cfg.lstm_layers)
        self.final = SConv1d(d, cfg.dimension, cfg.last_kernel_size)
        self.register_buffer("codebooks", torch.zeros(cfg.n_q, cfg.codebook_size,
                                                      cfg.dimension))

    def embed(self, audio):
        """(B, 1, T) float audio -> (B, dimension, T / hop) embeddings."""
        x = self.init(audio)
        for stage in self.stages:
            x = stage(x)
        h = x.permute(2, 0, 1)                          # (T, B, C)
        h = self.lstm(h)[0] + h
        return self.final(F.elu(h.permute(1, 2, 0)))

    def rvq_encode(self, emb):
        """(B, D, T) -> (B, n_q, T) codes, residual nearest neighbour per stage."""
        residual = emb.transpose(1, 2).float()
        codes = []
        for e in self.codebooks.float():
            dist = 2.0 * torch.matmul(residual, e.t()) - (e * e).sum(dim=-1)
            idx = torch.argmax(dist, dim=-1)
            residual = residual - e[idx]
            codes.append(idx)
        return torch.stack(codes, dim=1)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "EncodecEncoder":
        """Seeded random init with the JAX ``init_encodec`` distributions."""
        for name, p in self.named_parameters():
            if name.endswith("bias") or name.startswith("lstm.bias"):
                p.zero_()
            elif name.startswith("lstm."):
                p.normal_(generator=generator).mul_(0.05)
            else:
                p.normal_(generator=generator).mul_((p.shape[1] * p.shape[2]) ** -0.5)
        self.codebooks.normal_(generator=generator)
        return self

    @torch.inference_mode()
    def forward(self, audio):
        """(B, 1, T) audio, float in [-1, 1] or int16 PCM -> (B, n_q, frames)."""
        if audio.dtype == torch.int16:
            audio = audio.float() / 32768.0
        return self.rvq_encode(self.embed(audio))


def encodec_from_pytree(params, cfg: EncodecConfig | None = None) -> EncodecEncoder:
    """Build the encoder from the JAX package's Encodec pytree (numpy leaves)."""
    cfg = cfg or EncodecConfig.infer(params)
    model = EncodecEncoder(cfg)
    a = lambda v: torch.tensor(np.asarray(v, np.float32))
    sd = {"codebooks": a(params["codebooks"])}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = a(p["w"])
        sd[f"{prefix}.bias"] = a(p["b"])

    conv("init", params["init"])
    conv("final", params["final"])
    for i, st in enumerate(params["stages"]):
        for name in ("conv1", "conv2", "shortcut"):
            conv(f"stages.{i}.res.{name}", st["res"][name])
        conv(f"stages.{i}.down", st["down"])
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
             "b_hh": "bias_hh"}
    for i, lp in enumerate(params["lstm"]["layers"]):
        for k, name in names.items():
            sd[f"lstm.{name}_l{i}"] = a(lp[k])
    model.load_state_dict(sd, strict=True)
    return model


def _f32(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _fold_weight_norm(sd, prefix):
    """A conv of the official state dict -> {"w", "b"}: its ``weight_g`` /
    ``weight_v`` (weight norm) folded into one kernel ``g v / |v|``, the norm
    over each output channel, or its plain ``weight``."""
    if f"{prefix}.weight_g" in sd:
        g = _f32(sd[f"{prefix}.weight_g"])
        v = _f32(sd[f"{prefix}.weight_v"])
        norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
        w = g * v / norm
    else:
        w = _f32(sd[f"{prefix}.weight"])
    out = {"w": w}
    if f"{prefix}.bias" in sd:
        out["b"] = _f32(sd[f"{prefix}.bias"])
    return out


def convert_encodec(sd, cfg: EncodecConfig = EncodecConfig()):
    """Official ``encodec_24khz`` state dict -> the encoder and quantizer
    pytree ``encodec_from_pytree`` takes.

    Indices follow ``SEANetEncoder.model``'s sequence: 0 the first conv, then
    for each stage i a residual block at 3i + 1 and the downsampling conv at
    3i + 3 (the ELUs take indices and hold nothing), then the LSTM and, two
    further on, the last conv."""
    stages = []
    idx = 1
    for _ in cfg.ratios:
        stages.append({
            "res": {
                "conv1": _fold_weight_norm(sd, f"encoder.model.{idx}.block.1.conv.conv"),
                "conv2": _fold_weight_norm(sd, f"encoder.model.{idx}.block.3.conv.conv"),
                "shortcut": _fold_weight_norm(sd, f"encoder.model.{idx}.shortcut.conv.conv"),
            },
            "down": _fold_weight_norm(sd, f"encoder.model.{idx + 2}.conv.conv"),
        })
        idx += 3
    lstm_layers = [{k: _f32(sd[f"encoder.model.{idx}.lstm.{name}_l{i}"])
                    for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                    ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
                   for i in range(cfg.lstm_layers)]
    codebooks = np.stack([_f32(sd[f"quantizer.vq.layers.{q}._codebook.embed"])
                          for q in range(cfg.n_q)])
    return {"init": _fold_weight_norm(sd, "encoder.model.0.conv.conv"), "stages": stages,
            "lstm": {"layers": lstm_layers},
            "final": _fold_weight_norm(sd, f"encoder.model.{idx + 2}.conv.conv"),
            "codebooks": codebooks}
