"""CodecLM, the autoregressive codec language model
(counterpart of ``mars5_tts_tpu/models/ar.py``).

A Mistral-style decoder (26 layers, dim 1536, 24 heads of 64, SwiGLU 3584,
sliding window 3000) over the joint text + speech vocabulary, conditioned on
a speaker vector prepended at position 0. Parameter names follow the
reference ``CodecLM`` state dict, except that each head's wq/wk rows are in
the half-split RoPE order (``convert.permute_rope_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import banded_causal_mask, sdpa
from ..ops.embeddings import add_sine_pe, chunked_embed, lookup
from ..ops.norms import rms_norm
from ..ops.quant import is_quantized, linear_any
from ..ops.rope import apply_rope_halfsplit, rope_angles
from ..utils.masks import construct_padding_mask
from .layers import TransformerEncoder, init_params_, remat_default, run_layer


@dataclass(frozen=True)
class CodecLMConfig:
    n_vocab: int
    dim: int = 1536
    n_heads: int = 24
    n_kv_heads: int = 24
    head_dim: int = 64
    n_layers: int = 26
    hidden_dim: int = 3584          # int(1536 * 7/3)
    sliding_window: int = 3000
    norm_eps: float = 1e-5
    n_spk_layers: int = 2
    spk_hidden_dim: int = 4608      # speaker-encoder FFN
    codebook_size: int = 1025       # 1024 codes + pad
    n_codebooks: int = 8

    @classmethod
    def mars5(cls, n_vocab: int) -> "CodecLMConfig":
        """The released MARS5 English AR configuration."""
        return cls(n_vocab=n_vocab)

    @classmethod
    def tiny(cls, n_vocab: int = 64) -> "CodecLMConfig":
        """Small config for tests (head_dim stays 64, as in the reference)."""
        return cls(n_vocab=n_vocab, dim=64, n_heads=2, n_kv_heads=2, head_dim=64,
                   n_layers=2, hidden_dim=96, sliding_window=64, n_spk_layers=2,
                   spk_hidden_dim=192)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.wq = nn.Linear(cfg.dim, cfg.n_heads * cfg.head_dim, bias=False)
        self.wk = nn.Linear(cfg.dim, cfg.n_kv_heads * cfg.head_dim, bias=False)
        self.wv = nn.Linear(cfg.dim, cfg.n_kv_heads * cfg.head_dim, bias=False)
        self.wo = nn.Linear(cfg.n_heads * cfg.head_dim, cfg.dim, bias=False)


class FeedForward(nn.Module):
    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.w1 = nn.Linear(cfg.dim, cfg.hidden_dim, bias=False)
        self.w2 = nn.Linear(cfg.hidden_dim, cfg.dim, bias=False)
        self.w3 = nn.Linear(cfg.dim, cfg.hidden_dim, bias=False)

    def forward(self, h):
        return linear_any(F.silu(linear_any(h, self.w1.weight))
                          * linear_any(h, self.w3.weight), self.w2.weight)


class TransformerBlock(nn.Module):
    """One pre-norm Mistral block."""

    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = Attention(cfg)
        self.feed_forward = FeedForward(cfg)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)

    def qkv(self, x, cos, sin):
        """Roped q and k and v, each (B, L, H, D)."""
        cfg, a = self.cfg, self.attention
        b, l, _ = x.shape
        h = self.attention_norm(x)
        q = linear_any(h, a.wq.weight).reshape(b, l, cfg.n_heads, cfg.head_dim)
        k = linear_any(h, a.wk.weight).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        v = linear_any(h, a.wv.weight).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        return apply_rope_halfsplit(q, cos, sin), apply_rope_halfsplit(k, cos, sin), v

    def finish(self, x, attn):
        """Out-projection residual, then the FFN residual."""
        b, l = attn.shape[:2]
        x = x + linear_any(attn.reshape(b, l, -1), self.attention.wo.weight)
        return x + self.feed_forward(self.ffn_norm(x))

    def forward(self, x, cos, sin, mask):
        q, k, v = self.qkv(x, cos, sin)
        return self.finish(x, sdpa(q, k, v, mask)), (k, v)


class MistralTransformer(nn.Module):
    """The decoder blocks, final norm and output head; ``remat`` (default
    ``layers.remat_default()``): per-layer rematerialization in training."""

    def __init__(self, cfg: CodecLMConfig, remat: bool | None = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(TransformerBlock(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.output = nn.Linear(cfg.dim, cfg.n_vocab, bias=False)
        self.remat = remat_default(remat)

    def forward(self, x, positions, mask=None):
        """x (bs, L, dim) embedded inputs -> (logits (bs, L, V), [(k, v)] per
        layer). With L > 1 and no mask, the banded causal mask is used."""
        cfg = self.cfg
        l = x.shape[1]
        cos, sin = rope_angles(positions, cfg.head_dim)
        if mask is None and l > 1:
            mask = banded_causal_mask(l, cfg.sliding_window, device=x.device)
        kvs = []
        for layer in self.layers:
            x, kv = run_layer(self.remat, layer, x, cos, sin, mask)
            kvs.append(kv)
        return linear_any(self.norm(x), self.output.weight), kvs


class SinePositionalEmbedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return add_sine_pe(x, self.alpha)


class ChunkedEmbedding(nn.Module):
    """One table per codebook; lookups concatenated along features."""

    def __init__(self, n_codebooks: int, codebook_size: int, dim: int):
        super().__init__()
        self.embs = nn.ModuleList(nn.Embedding(codebook_size, dim // n_codebooks)
                                  for _ in range(n_codebooks))

    def forward(self, x):
        return chunked_embed([e.weight for e in self.embs], x)


class CodecLM(nn.Module):
    """``remat``: per-layer rematerialization of every stack in training
    (default ``MARS5_TRAIN_REMAT``)."""

    def __init__(self, cfg: CodecLMConfig, remat: bool | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.n_vocab, cfg.dim)
        self.ar = MistralTransformer(cfg, remat)
        self.pos_embedding = SinePositionalEmbedding()
        self.ref_chunked_emb = ChunkedEmbedding(cfg.n_codebooks, cfg.codebook_size,
                                                cfg.dim)
        self.spk_identity_emb = nn.Embedding(1, cfg.dim)
        self.spk_encoder = TransformerEncoder(cfg.dim, cfg.n_heads,
                                              cfg.spk_hidden_dim, cfg.n_spk_layers, remat)

    @property
    def is_quantized(self) -> bool:
        """Its block weights and head are int8 (``ops/quant.quantize_codeclm``)."""
        return is_quantized(self.ar.output.weight)

    def spk_embedding(self, spk_codes):
        """(bs, S, 8) reference codes -> (bs, dim) implicit speaker vector:
        chunked embed, prepend the identity token, sine positions, mask from
        the first pad code (1024) in codebook 0 on, 2-layer encoder, row 0."""
        bs = spk_codes.shape[0]
        seq = self.ref_chunked_emb(spk_codes)
        ident = self.spk_identity_emb.weight[None].expand(bs, 1, -1).to(seq.dtype)
        seq = self.pos_embedding(torch.cat([ident, seq], dim=1))
        pad = construct_padding_mask(spk_codes[:, :, 0], self.cfg.codebook_size - 1)
        pad = torch.cat([torch.zeros((bs, 1), dtype=torch.bool, device=pad.device), pad],
                        dim=1)
        return self.spk_encoder(seq, key_padding_mask=pad)[:, 0]

    def forward(self, tokens, spk_codes=None, spk_vector=None):
        """(bs, L) tokens -> (bs, L, vocab) logits; a speaker vector (given, or
        from ``spk_codes``) sits at position 0 and its output row is dropped."""
        x = lookup(self.embed.weight, tokens)
        has_spk = spk_codes is not None or spk_vector is not None
        if has_spk:
            if spk_vector is None:
                spk_vector = self.spk_embedding(spk_codes)
            x = torch.cat([spk_vector[:, None].to(x.dtype), x], dim=1)
        logits, _ = self.ar(x, torch.arange(x.shape[1], device=x.device))
        return logits[:, 1:] if has_spk else logits

    def prefill(self, tokens, spk_vector):
        """(all logits incl. the speaker row, per-layer (k, v)) for decode."""
        x = lookup(self.embed.weight, tokens)
        x = torch.cat([spk_vector[:, None].to(x.dtype), x], dim=1)
        return self.ar(x, torch.arange(x.shape[1], device=x.device))

    def init_(self, generator: torch.Generator) -> "CodecLM":
        """Seeded random init at any config (tests, benchmarks)."""
        init_params_(self, generator, embedding_names=(
            "embed.", "ref_chunked_emb.", "spk_identity_emb."))
        return self
