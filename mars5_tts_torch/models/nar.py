"""ResidualTransformer, the NAR multinomial-diffusion denoiser
(counterpart of ``mars5_tts_tpu/models/nar.py``).

Encoder-decoder transformer (8 encoder / 16 decoder layers, dim 1024, 16
heads, SwiGLU 3072). Encoder input: [speaker vector] ++ text embeddings with
sine positions plus the encoder timestep MLP; decoder input: chunked embedding
of x_t with sine positions plus the decoder timestep MLP; output: 8
LayerNorm(eps 1e-5) -> Linear heads, returned as (bs, L, lanes, n_quant).
Parameter names follow the reference ``ResidualTransformer`` state dict.

The W8A8 serving path (``ops/quant.quantize_nar``) folds the heads' LayerNorm
affines into the quantized head weights (``fold_quant_heads``): one normalise,
one activation quant and one GEMM over all requested lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import linear
from ..ops.embeddings import lookup, timestep_embedding
from ..ops.quant import int8_matmul, is_quantized, linear_any, quantize_act
from ..utils.masks import length_to_mask
from .ar import ChunkedEmbedding, SinePositionalEmbedding
from .layers import (DEFAULT_OPTIONS, LayerNorm, NarOptions, TransformerDecoder,
                     TransformerEncoder, init_params_)


@dataclass(frozen=True)
class ResidualTransformerConfig:
    n_text_vocab: int
    n_quant: int = 1025             # classes per codebook (1024 + pad)
    dim: int = 1024
    nhead: int = 16
    enc_layers: int = 8
    dec_layers: int = 16
    n_spk_layers: int = 3
    c_quant_levels: int = 8
    pred_quant_levels: int = 8
    t_emb_dim: int = 1024
    hidden_dim: int = 3072

    @classmethod
    def mars5(cls, n_text_vocab: int) -> "ResidualTransformerConfig":
        return cls(n_text_vocab=n_text_vocab)

    @classmethod
    def tiny(cls, n_text_vocab: int = 32, n_quant: int = 1025) -> "ResidualTransformerConfig":
        return cls(n_text_vocab=n_text_vocab, n_quant=n_quant, dim=64, nhead=4,
                   enc_layers=2, dec_layers=2, n_spk_layers=2, t_emb_dim=64,
                   hidden_dim=192)


class Transformer(nn.Module):
    """The ``tfm`` encoder/decoder pair."""

    def __init__(self, cfg: ResidualTransformerConfig, remat: bool | None = None):
        super().__init__()
        self.encoder = TransformerEncoder(cfg.dim, cfg.nhead, cfg.hidden_dim,
                                          cfg.enc_layers, remat)
        self.decoder = TransformerDecoder(cfg.dim, cfg.nhead, cfg.hidden_dim,
                                          cfg.dec_layers, remat)


def _timestep_mlp(cfg: ResidualTransformerConfig):
    return nn.Sequential(nn.Linear(cfg.t_emb_dim, cfg.dim), nn.SiLU(),
                         nn.Linear(cfg.dim, cfg.dim))


def _head(cfg: ResidualTransformerConfig):
    return nn.Sequential(LayerNorm(cfg.dim, eps=1e-5), nn.Linear(cfg.dim, cfg.n_quant))


def _mlp(seq: nn.Sequential, x):
    return linear(F.silu(linear(x, seq[0].weight, seq[0].bias)), seq[2].weight, seq[2].bias)


class ResidualTransformer(nn.Module):
    """``remat``: per-layer rematerialization of every stack in training
    (default ``MARS5_TRAIN_REMAT``)."""

    def __init__(self, cfg: ResidualTransformerConfig, remat: bool | None = None):
        super().__init__()
        self.cfg = cfg
        self.text_embed = nn.Embedding(cfg.n_text_vocab, cfg.dim)
        self.cond_pos_embedding = SinePositionalEmbedding()
        self.pos_embedding = SinePositionalEmbedding()
        self.ref_pos_embedding = SinePositionalEmbedding()
        self.tfm = Transformer(cfg, remat)
        self.timestep_encoder_emb = _timestep_mlp(cfg)
        self.timestep_decoder_emb = _timestep_mlp(cfg)
        self.ref_embedder = ChunkedEmbedding(cfg.c_quant_levels, cfg.n_quant, cfg.dim)
        self.spk_identity_emb = nn.Embedding(1, cfg.dim)
        self.spk_encoder = TransformerEncoder(cfg.dim, cfg.nhead, cfg.hidden_dim,
                                              cfg.n_spk_layers, remat)
        self.residual_encoder = ChunkedEmbedding(cfg.c_quant_levels, cfg.n_quant,
                                                 cfg.dim)
        self.residual_decoder = nn.ModuleList(_head(cfg)
                                              for _ in range(cfg.pred_quant_levels))

    @property
    def is_quantized(self) -> bool:
        return is_quantized(self.residual_decoder[0][1].weight)

    def spk_embedding(self, c_codes, c_codes_length, options: NarOptions = DEFAULT_OPTIONS):
        """(bs, S, 8) reference codes and (bs,) lengths -> (bs, dim);
        ``options`` the speaker encoder's routes."""
        bs, sl = c_codes.shape[:2]
        seq = self.ref_embedder(c_codes)
        ident = self.spk_identity_emb.weight[None].expand(bs, 1, -1).to(seq.dtype)
        seq = self.ref_pos_embedding(torch.cat([ident, seq], dim=1))
        pad = length_to_mask(c_codes_length + 1, torch.zeros_like(c_codes_length), sl + 1)
        return self.spk_encoder(seq, key_padding_mask=pad, options=options)[:, 0]

    def timestep_mlps(self, t, dtype):
        """t (bs,) -> the encoder and decoder timestep embeddings, (bs, dim) each."""
        t_emb = timestep_embedding(t, self.cfg.t_emb_dim, dtype=dtype)
        return (_mlp(self.timestep_encoder_emb, t_emb),
                _mlp(self.timestep_decoder_emb, t_emb))

    def enc_inputs(self, c_text, c_texts_length, spk):
        """Timestep-free encoder stream [spk] ++ text with sine positions, and
        its padding mask; the encoder input at step t is ``c + t_enc[:, None]``."""
        text_emb = lookup(self.text_embed.weight, c_text)
        c = torch.cat([spk[:, None].to(text_emb.dtype), text_emb], dim=1)
        c_lengths = c_texts_length + 1
        c_padding = length_to_mask(c_lengths, torch.zeros_like(c_lengths), c.shape[1])
        return self.cond_pos_embedding(c), c_padding

    def decoder_stream(self, x, t_dec):
        """The decoder's input: x (bs, Lx, 8) codes embedded, with sine
        positions, plus the timestep embedding t_dec (bs, dim)."""
        return self.pos_embedding(self.residual_encoder(x)) + t_dec[:, None]

    def decoder_apply(self, x, x_padding_mask, t_dec, memory, c_padding,
                      q_tail_start: int = 0, mega=None,
                      options: NarOptions = DEFAULT_OPTIONS, graphs=None):
        """Decoder stream and stack over a precomputed encoder memory;
        returns (bs, Lx - q_tail_start, dim). ``mega``: the decoder's
        ``build_mega_pack``, to run the stack through kernel K9; ``options``
        the layers' routes; ``graphs``: a trajectory's
        ``nar_graphs.DecoderGraphs``, which replays the stack as CUDA graphs
        where it takes the call (its output is then valid until its next
        call), else the stack runs eagerly."""
        dec = self.tfm.decoder
        if graphs is not None and graphs.takes(dec, x, mega, options):
            return graphs.run(self, x, t_dec, memory, x_padding_mask, c_padding,
                              q_tail_start, options)
        return dec(self.decoder_stream(x, t_dec), memory, tgt_key_padding_mask=x_padding_mask,
                   memory_key_padding_mask=c_padding, q_tail_start=q_tail_start, mega=mega,
                   options=options)

    def backbone(self, c_text, c_codes, c_texts_length, c_codes_length, x,
                 x_padding_mask, t, drop_cond=None, spk=None,
                 options: NarOptions = DEFAULT_OPTIONS):
        """Everything up to the output heads: (bs, Lx, dim)."""
        if spk is None:
            if drop_cond is not None:
                c_codes_length = torch.where(drop_cond, 0, c_codes_length)
                c_codes = torch.where(drop_cond[:, None, None], self.cfg.n_quant - 1,
                                      c_codes)
            spk = self.spk_embedding(c_codes, c_codes_length, options)
        t_enc, t_dec = self.timestep_mlps(t, self.text_embed.weight.dtype)
        c, c_padding = self.enc_inputs(c_text, c_texts_length, spk)
        memory = self.tfm.encoder(c + t_enc[:, None], key_padding_mask=c_padding,
                                  options=options)
        return self.decoder_apply(x, x_padding_mask, t_dec, memory, c_padding,
                                  options=options)

    def heads(self, out, lanes=None):
        """Per-codebook LayerNorm -> Linear heads: (bs, L, len(lanes), n_quant)."""
        lanes = range(self.cfg.pred_quant_levels) if lanes is None else lanes
        outs = []
        for i in lanes:
            ln, lin = self.residual_decoder[i]
            outs.append(linear_any(ln(out), lin.weight, lin.bias))
        return torch.stack(outs, dim=2)

    def forward(self, c_text, c_codes, c_texts_length, c_codes_length, x,
                x_padding_mask, t, drop_cond=None, spk=None):
        """Backbone plus all 8 heads: (bs, Lx, 8, n_quant) x0 logits."""
        return self.heads(self.backbone(c_text, c_codes, c_texts_length,
                                        c_codes_length, x, x_padding_mask, t,
                                        drop_cond=drop_cond, spk=spk))

    def init_(self, generator: torch.Generator) -> "ResidualTransformer":
        """Seeded random init at any config (tests, benchmarks)."""
        init_params_(self, generator, embedding_names=(
            "text_embed.", "ref_embedder.", "residual_encoder.", "spk_identity_emb."))
        return self


def fold_quant_heads(model: ResidualTransformer, lanes: tuple) -> dict:
    """Fold the quantized heads' LayerNorm affines into their weights.

    Every head normalises the same decoder output and differs only in its
    affine (w_i, b_i), so LN_i(out) @ W_i^T + c_i = n @ (W_i * w_i)^T +
    (W_i @ b_i + c_i) with n the plain normalisation. Returns {"q" (n_lanes,
    n_quant, dim) int8, "s" f32, "b" f32}: the folded weights requantized per
    output row (a once-per-trajectory precompute).
    """
    heads = [model.residual_decoder[i] for i in lanes]
    q = torch.stack([h[1].weight.q for h in heads])
    s = torch.stack([h[1].weight.s for h in heads])
    lnw = torch.stack([h[0].weight.float() for h in heads])
    lnb = torch.stack([h[0].bias.float() for h in heads])
    bias = torch.stack([h[1].bias.float() for h in heads])
    wf = q.float() * s[..., None]
    wfold = wf * lnw[:, None, :]
    bfold = torch.einsum("lnd,ld->ln", wf, lnb) + bias
    s2 = wfold.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q2 = torch.round(wfold / s2[..., None]).clamp(-127, 127).to(torch.int8)
    return {"q": q2, "s": s2, "b": bfold}


def nar_heads_prequant(out, eps: float = 1e-5):
    """The heads' shared LayerNorm (no affine; rounded to out's dtype) and
    per-row int8 quant: (x8 int8, xs f32 (..., 1)), the input of K6."""
    xf = out.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return quantize_act(((xf - mean) * torch.rsqrt(var + eps)).to(out.dtype))


def nar_heads_folded(folded: dict, out, eps: float = 1e-5):
    """Folded W8A8 heads: (bs, L, n_lanes, n_quant) logits in out's dtype."""
    xq, xs = nar_heads_prequant(out, eps)
    n, nq, d = folded["q"].shape
    y = int8_matmul(xq, folded["q"].reshape(n * nq, d)).float()
    y = y * (xs * folded["s"].reshape(-1)) + folded["b"].reshape(-1)
    return y.reshape(*out.shape[:2], n, nq).to(out.dtype)
