"""Vocos vocoder, charactr/vocos-encodec-24khz
(counterpart of ``mars5_tts_tpu/models/vocos.py``).

codes -> summed Encodec codebook embeddings -> Conv1d(k7) embed ->
AdaLayerNorm -> ConvNeXt blocks -> LayerNorm -> Linear to log-magnitude and
phase -> inverse STFT with "same" padding: framed irfft, Hann-windowed
overlap-add divided by the squared-window envelope, (n_fft - hop) / 2
samples cropped on each side (not ``torch.istft``, whose padding differs).
Weights come from a parameter pytree of numpy leaves (the JAX package's
layout) through ``vocos_from_pytree``; ``convert_vocos`` makes that pytree
from an official ``vocos-encodec-24khz`` state dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 128
    dim: int = 384
    intermediate_dim: int = 1152
    num_layers: int = 8
    adanorm_num_embeddings: int = 4
    n_fft: int = 1280
    hop_length: int = 320
    n_codebooks: int = 8
    codebook_size: int = 1024
    eps: float = 1e-6

    @classmethod
    def mars5(cls) -> "VocosConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VocosConfig":
        return cls(input_channels=8, dim=16, intermediate_dim=32, num_layers=2,
                   n_fft=64, hop_length=16, n_codebooks=4, codebook_size=32)

    @classmethod
    def infer(cls, params, codebook_size: int = 1024, hop_length: int | None = None):
        """The config implied by a parameter pytree's shapes (hop defaults to
        n_fft // 4, as released)."""
        dim, input_channels, _ = np.shape(params["embed_w"])
        n_fft = np.shape(params["head"]["out_w"])[0] - 2
        return cls(input_channels=int(input_channels), dim=int(dim),
                   intermediate_dim=int(np.shape(params["convnext"][0]["pwconv1_w"])[0]),
                   num_layers=len(params["convnext"]),
                   adanorm_num_embeddings=int(np.shape(params["norm"]["scale"])[0]),
                   n_fft=int(n_fft), hop_length=int(hop_length or n_fft // 4),
                   n_codebooks=int(np.shape(params["codebook_weights"])[0] // codebook_size),
                   codebook_size=codebook_size)


def codes_to_features(codebook_weights, codes, bins: int = 1024):
    """(K, T) or (K, B, T) codes -> (B, C, T): the sum of codebook k's rows
    ``[k * bins, (k + 1) * bins)``. A row index past the table (the pad code
    1024 in the last codebook, which the diffusion may draw) is clamped to
    the last row, as the JAX package's gather clamps it."""
    if codes.ndim == 2:
        codes = codes[:, None]
    k = codes.shape[0]
    offsets = (torch.arange(k, device=codes.device) * bins).reshape(k, 1, 1)
    idx = (codes + offsets).clamp(max=codebook_weights.shape[0] - 1)
    return codebook_weights[idx].sum(dim=0).transpose(1, 2)


def _norm(x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class AdaLayerNorm(nn.Module):
    def __init__(self, n_emb: int, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n_emb, dim))
        self.shift = nn.Parameter(torch.zeros(n_emb, dim))

    def forward(self, x, cond_id: int):
        return _norm(x, self.eps) * self.scale[cond_id] + self.shift[cond_id]


class ConvNeXtBlock(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.dwconv = nn.Conv1d(cfg.dim, cfg.dim, 7, padding=3, groups=cfg.dim)
        self.norm = AdaLayerNorm(cfg.adanorm_num_embeddings, cfg.dim, cfg.eps)
        self.pwconv1 = nn.Linear(cfg.dim, cfg.intermediate_dim)
        self.pwconv2 = nn.Linear(cfg.intermediate_dim, cfg.dim)
        self.gamma = nn.Parameter(torch.ones(cfg.dim))

    def forward(self, x, cond_id: int):
        """(B, C, T) -> (B, C, T)."""
        h = self.norm(self.dwconv(x).transpose(1, 2), cond_id)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + (self.gamma * h).transpose(1, 2)


def istft_same(spec, n_fft: int, hop_length: int, window):
    """spec complex (B, n_fft // 2 + 1, T) -> (B, (T - 1) * hop + n_fft - 2 * pad)
    audio, pad = (n_fft - hop) // 2 (T * hop at the released 1280 / 320).

    Overlap-add as r = ceil(n_fft / hop) staggered adds of hop-sized segments
    (each frame zero-padded to r * hop)."""
    pad = (n_fft - hop_length) // 2
    frames = torch.fft.irfft(spec, n=n_fft, dim=1) * window[None, :, None]
    b, _, t = frames.shape
    r = -(-n_fft // hop_length)
    extra = r * hop_length - n_fft
    frames = F.pad(frames, (0, 0, 0, extra))
    w2 = F.pad(window * window, (0, extra)).reshape(r, hop_length)
    chunks = frames.new_zeros((b, t + r - 1, hop_length))
    env = frames.new_zeros((t + r - 1, hop_length))
    for s in range(r):
        chunks[:, s:s + t] += frames[:, s * hop_length:(s + 1) * hop_length].transpose(1, 2)
        env[s:s + t] += w2[s][None]
    out_len = (t - 1) * hop_length + n_fft
    audio = chunks.reshape(b, -1)[:, :out_len] / torch.clamp(env.reshape(-1)[:out_len],
                                                            min=1e-11)[None]
    return audio[:, pad:out_len - pad]


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = AdaLayerNorm(cfg.adanorm_num_embeddings, cfg.dim, cfg.eps)
        self.convnext = nn.ModuleList(ConvNeXtBlock(cfg) for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.out = nn.Linear(cfg.dim, cfg.n_fft + 2)
        self.register_buffer("codebook_weights", torch.zeros(
            cfg.n_codebooks * cfg.codebook_size, cfg.input_channels))
        window = np.hanning(cfg.n_fft + 1)[:-1].astype(np.float32)
        self.register_buffer("window", torch.from_numpy(window), persistent=False)

    def backbone(self, features, bandwidth_id: int):
        """(B, C_in, T) -> (B, T, dim)."""
        x = self.norm(self.embed(features).transpose(1, 2), bandwidth_id).transpose(1, 2)
        for block in self.convnext:
            x = block(x, bandwidth_id)
        x = x.transpose(1, 2)
        ln = self.final_layer_norm
        return _norm(x, self.cfg.eps) * ln.weight + ln.bias

    def head(self, x):
        """(B, T, dim) -> (B, samples)."""
        mag, phase = self.out(x).transpose(1, 2).chunk(2, dim=1)
        mag = torch.exp(torch.clamp(mag, max=1e2))
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft_same(spec, self.cfg.n_fft, self.cfg.hop_length, self.window)

    @torch.inference_mode()
    def decode(self, features, bandwidth_id: int):
        return self.head(self.backbone(features, bandwidth_id))

    @torch.inference_mode()
    def vocode(self, tokens, bandwidth_id: int = 1):
        """(T, n_q) token grid -> (samples,) 24 kHz audio. bandwidth_id 1 is
        the reference's 3 kbps smoothing setting on 6 kbps tokens."""
        feats = codes_to_features(self.codebook_weights, tokens.t(),
                                  bins=self.cfg.codebook_size)
        return self.decode(feats, bandwidth_id)[0]

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Vocos":
        """Seeded random init with the JAX ``init_vocos`` distributions."""
        def normal(t, std):
            return t.normal_(generator=generator).mul_(std)

        for blk in self.convnext:
            normal(blk.dwconv.weight, 0.2)
            blk.dwconv.bias.zero_()
            blk.norm.scale.fill_(1.0)
            blk.norm.shift.zero_()
            for lin in (blk.pwconv1, blk.pwconv2):
                normal(lin.weight, lin.weight.shape[1] ** -0.5)
                lin.bias.zero_()
            blk.gamma.fill_(1.0 / self.cfg.num_layers)
        normal(self.embed.weight, 0.1)
        self.embed.bias.zero_()
        self.norm.scale.fill_(1.0)
        self.norm.shift.zero_()
        self.final_layer_norm.weight.fill_(1.0)
        self.final_layer_norm.bias.zero_()
        normal(self.out.weight, self.out.weight.shape[1] ** -0.5)
        self.out.bias.zero_()
        normal(self.codebook_weights, 1.0)
        return self


def vocos_from_pytree(params, cfg: VocosConfig | None = None) -> Vocos:
    """Build the vocoder from the JAX package's Vocos pytree (numpy leaves)."""
    cfg = cfg or VocosConfig.infer(params)
    model = Vocos(cfg)
    a = lambda v: torch.tensor(np.asarray(v, np.float32))
    sd = {"embed.weight": a(params["embed_w"]), "embed.bias": a(params["embed_b"]),
          "norm.scale": a(params["norm"]["scale"]), "norm.shift": a(params["norm"]["shift"]),
          "final_layer_norm.weight": a(params["final_ln_w"]),
          "final_layer_norm.bias": a(params["final_ln_b"]),
          "out.weight": a(params["head"]["out_w"]), "out.bias": a(params["head"]["out_b"]),
          "codebook_weights": a(params["codebook_weights"])}
    for i, blk in enumerate(params["convnext"]):
        pre = f"convnext.{i}"
        sd.update({f"{pre}.dwconv.weight": a(blk["dwconv_w"]),
                   f"{pre}.dwconv.bias": a(blk["dwconv_b"]),
                   f"{pre}.norm.scale": a(blk["norm"]["scale"]),
                   f"{pre}.norm.shift": a(blk["norm"]["shift"]),
                   f"{pre}.pwconv1.weight": a(blk["pwconv1_w"]),
                   f"{pre}.pwconv1.bias": a(blk["pwconv1_b"]),
                   f"{pre}.pwconv2.weight": a(blk["pwconv2_w"]),
                   f"{pre}.pwconv2.bias": a(blk["pwconv2_b"]),
                   f"{pre}.gamma": a(blk["gamma"])})
    model.load_state_dict(sd, strict=True)
    return model


def convert_vocos(sd, cfg: VocosConfig = VocosConfig()):
    """Official ``vocos-encodec-24khz`` state dict -> the pytree
    ``vocos_from_pytree`` takes. Keys: ``backbone.embed``, ``backbone.norm``
    (``scale.weight``, ``shift.weight``), ``backbone.convnext.{i}.*``,
    ``backbone.final_layer_norm``, ``head.out`` and the Encodec codebooks
    ``feature_extractor.encodec.quantizer.vq.layers.{k}._codebook.embed``,
    stacked into one table."""
    def a(k):
        v = sd[k]
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"backbone.convnext.{i}"
        blocks.append({
            "dwconv_w": a(f"{pre}.dwconv.weight"), "dwconv_b": a(f"{pre}.dwconv.bias"),
            "norm": {"scale": a(f"{pre}.norm.scale.weight"),
                     "shift": a(f"{pre}.norm.shift.weight")},
            "pwconv1_w": a(f"{pre}.pwconv1.weight"), "pwconv1_b": a(f"{pre}.pwconv1.bias"),
            "pwconv2_w": a(f"{pre}.pwconv2.weight"), "pwconv2_b": a(f"{pre}.pwconv2.bias"),
            "gamma": a(f"{pre}.gamma"),
        })
    codebooks = np.concatenate([
        a(f"feature_extractor.encodec.quantizer.vq.layers.{k}._codebook.embed")
        for k in range(cfg.n_codebooks)], axis=0)
    return {
        "embed_w": a("backbone.embed.weight"), "embed_b": a("backbone.embed.bias"),
        "norm": {"scale": a("backbone.norm.scale.weight"),
                 "shift": a("backbone.norm.shift.weight")},
        "convnext": blocks,
        "final_ln_w": a("backbone.final_layer_norm.weight"),
        "final_ln_b": a("backbone.final_layer_norm.bias"),
        "head": {"out_w": a("head.out.weight"), "out_b": a("head.out.bias")},
        "codebook_weights": codebooks,
    }
