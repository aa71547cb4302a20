"""Plain float32 building blocks of both models: norms, positions, the
norm-first transformer layer with SwiGLU, multi-head attention. A weight
given as a dequantized quantized matrix may quantize its input rows
(``levels``), as a W8A8 product does."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import quant


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def layer_norm(x, w=None, b=None, eps=4e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y if w is None else y * w + b


def sine_pe(length, dim, device):
    """pe[:, 0::2] = sin, pe[:, 1::2] = cos (the reference's
    ``SinePositionalEmbedding``)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    return torch.stack([torch.sin(pos * div), torch.cos(pos * div)], dim=-1).reshape(length, -1)


def rope(x, positions):
    """Rotary positions on x (..., L, H, D) at ``positions`` (L,), rotating
    (i, i + D/2) pairs: the half-split layout of the weights the benchmark
    draws (the released checkpoints rotate interleaved pairs; the port
    permutes their rows once, which leaves scores unchanged)."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def lin(x, w, b=None, levels=None):
    """x @ w.T (+ b); with ``levels`` the rows of x are quantized first."""
    if levels is not None:
        x = quant.act(x, levels)
    y = x @ w.t()
    return y if b is None else y + b


def attention(q, k, v, keep=None):
    """q (B, Lq, H, D), k/v (B, Lk, H, D); keep broadcastable to (B, H, Lq,
    Lk), True where a key counts. Softmax in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def mha(p, pre, q_in, kv_in, nhead, key_pad=None, levels=None):
    """torch ``nn.MultiheadAttention`` (batch first) with the parameters under
    ``pre``; key_pad (B, Lk) True where a key is padding."""
    w, b = p[pre + "in_proj_weight"], p[pre + "in_proj_bias"]
    d = q_in.shape[-1]
    q = lin(q_in, w[:d], b[:d], levels)
    kv = lin(kv_in, w[d:], b[d:], levels)
    k, v = kv[..., :d], kv[..., d:]
    bsz, lq, lk, hd = q.shape[0], q.shape[1], k.shape[1], d // nhead
    keep = None if key_pad is None else ~key_pad[:, None, None, :]
    out = attention(q.reshape(bsz, lq, nhead, hd), k.reshape(bsz, lk, nhead, hd),
                    v.reshape(bsz, lk, nhead, hd), keep).reshape(bsz, lq, d)
    return lin(out, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"], levels)


def ffn(p, pre, h, levels=None):
    """SwiGLU ``silu(h W^T) * h V^T``, then ``linear2``."""
    u = (F.silu(lin(h, p[pre + "activation.W.weight"], levels=levels))
         * lin(h, p[pre + "activation.V.weight"], levels=levels))
    return lin(u, p[pre + "linear2.weight"], p[pre + "linear2.bias"], levels)


def encoder_layer(p, pre, x, nhead, key_pad=None, levels=None):
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    x = x + mha(p, pre + "self_attn.", h, h, nhead, key_pad, levels)
    return x + ffn(p, pre, layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"]), levels)


def decoder_layer(p, pre, x, memory, nhead, self_pad, mem_pad, levels=None):
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    x = x + mha(p, pre + "self_attn.", h, h, nhead, self_pad, levels)
    h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
    x = x + mha(p, pre + "multihead_attn.", h, memory, nhead, mem_pad, levels)
    return x + ffn(p, pre, layer_norm(x, p[pre + "norm3.weight"], p[pre + "norm3.bias"]), levels)


def encoder(p, pre, x, n_layers, nhead, key_pad=None, levels=None):
    """Encoder layers, then the stack's LayerNorm (eps 4e-5)."""
    for i in range(n_layers):
        x = encoder_layer(p, f"{pre}layers.{i}.", x, nhead, key_pad, levels)
    return layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"])


def chunked(p, pre, codes, n):
    """Per-codebook lookups of codes (..., n), concatenated."""
    return torch.cat([p[f"{pre}embs.{i}.weight"][codes[..., i]] for i in range(n)], dim=-1)
