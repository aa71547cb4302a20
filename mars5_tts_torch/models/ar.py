"""CodecLM, the autoregressive codec language model
(counterpart of ``mars5_tts_tpu/models/ar.py``).

A Mistral-style decoder (26 layers, dim 1536, 24 heads of 64, SwiGLU 3584,
sliding window 3000) over the joint text + speech vocabulary, conditioned on
a speaker vector prepended at position 0. Parameter names follow the
reference ``CodecLM`` state dict, except that each head's wq/wk rows are in
the half-split RoPE order (``convert.permute_rope_rows``).

The same wrapper takes a DeepSeek-V2 block as its backbone
(``attention="mla"`` with ``n_routed_experts > 0``; HF ``modeling_deepseek``,
V2): multi-head latent attention without a q LoRA (``MLAttention``: a
``kv_lora_rank``-wide latent and one roped key shared by the heads, YaRN
frequencies and scale) and, past the first ``first_k_dense`` layers, a
mixture of experts (``MoEFeedForward``: a softmax router, top-k not
renormalised, experts stored (E, out, in), shared experts as one SwiGLU).
Its rope rows (``wq``'s ``q_pe`` rows, ``wkv_a``'s ``k_pe`` rows) are in
the half-split order too.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import NEG_INF, banded_causal_mask, linear, sdpa
from ..ops.embeddings import add_sine_pe, chunked_embed, lookup
from ..ops.kernels.moe_decode import moe_decode
from ..ops.norms import rms_norm
from ..ops.quant import is_quantized, linear_any
from ..ops.rope import (ROPE_THETA, apply_rope_halfsplit, rope_angles, rope_angles_freq,
                        yarn_inv_freq, yarn_mscale)
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
    # DeepSeek-V2 latent attention (attention="mla"); head_dim is then the
    # q / k head size, qk_nope_head_dim + qk_rope_head_dim
    attention: str = "mha"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN over the rope dims (rope_factor 1: plain rotary frequencies)
    rope_factor: float = 1.0
    rope_original_max_pos: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # mixture of experts past the first first_k_dense layers (0 experts: none)
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    n_experts_per_tok: int = 0
    moe_hidden_dim: int = 0
    first_k_dense: int = 0
    routed_scaling_factor: float = 1.0

    def __post_init__(self):
        if self.attention not in ("mha", "mla"):
            raise ValueError(f"unknown attention {self.attention!r}: 'mha' or 'mla'")
        if self.attention == "mla" and (
                min(self.kv_lora_rank, self.qk_nope_head_dim, self.qk_rope_head_dim,
                    self.v_head_dim) <= 0 or self.qk_rope_head_dim % 2
                or self.head_dim != self.qk_nope_head_dim + self.qk_rope_head_dim):
            raise ValueError("attention='mla' needs kv_lora_rank, qk_nope_head_dim, an even "
                             "qk_rope_head_dim and v_head_dim > 0, and head_dim = "
                             "qk_nope_head_dim + qk_rope_head_dim")
        if self.n_routed_experts and not (
                0 < self.n_experts_per_tok <= self.n_routed_experts
                and self.moe_hidden_dim > 0 and 0 <= self.first_k_dense <= self.n_layers):
            raise ValueError("a mixture of experts needs 0 < n_experts_per_tok <= "
                             "n_routed_experts, moe_hidden_dim > 0 and first_k_dense in "
                             "[0, n_layers]")

    def to_dict(self) -> dict:
        """The fields to save beside a checkpoint: the release's, and each
        later one only where it differs from its default, so that a MARS5
        block's config stays the one the JAX package reads."""
        fs = fields(self)
        first_new = [f.name for f in fs].index("attention")
        return {f.name: getattr(self, f.name) for i, f in enumerate(fs)
                if i < first_new or getattr(self, f.name) != f.default}

    @property
    def is_mha(self) -> bool:
        """The released MARS5 block: multi-head attention and a dense SwiGLU
        in every layer, the only block the quantized engine (K2), the int4
        head (K8) and tensor parallelism take."""
        return self.attention == "mha" and not self.n_routed_experts

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.n_routed_experts) and i >= self.first_k_dense

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
    """``tp`` (``parallel.tp.TensorParallel``): this rank's heads only, wo
    row-parallel (its product reduced in ``TransformerBlock.finish``)."""

    tp = None

    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.wq = nn.Linear(cfg.dim, cfg.n_heads * cfg.head_dim, bias=False)
        self.wk = nn.Linear(cfg.dim, cfg.n_kv_heads * cfg.head_dim, bias=False)
        self.wv = nn.Linear(cfg.dim, cfg.n_kv_heads * cfg.head_dim, bias=False)
        self.wo = nn.Linear(cfg.n_heads * cfg.head_dim, cfg.dim, bias=False)


class FeedForward(nn.Module):
    """``tp``: w1 / w3 column- and w2 row-parallel, the product reduced."""

    tp = None

    def __init__(self, cfg: CodecLMConfig, hidden: int | None = None):
        super().__init__()
        hidden = cfg.hidden_dim if hidden is None else hidden
        self.w1 = nn.Linear(cfg.dim, hidden, bias=False)
        self.w2 = nn.Linear(hidden, cfg.dim, bias=False)
        self.w3 = nn.Linear(cfg.dim, hidden, bias=False)

    def forward(self, h):
        y = linear_any(F.silu(linear_any(h, self.w1.weight))
                       * linear_any(h, self.w3.weight), self.w2.weight)
        return y if self.tp is None else self.tp.reduce(y)


@functools.lru_cache(maxsize=16)
def _yarn_freq(dim: int, theta: float, factor: float, original: int, fast: float, slow: float,
               device: str):
    """``yarn_inv_freq`` on ``device``, made once per device (a decode step
    copies nothing from the host)."""
    return yarn_inv_freq(dim, theta, factor, original, fast, slow).to(device)


class MLAttention(nn.Module):
    """DeepSeek-V2 multi-head latent attention without a q LoRA:
    ``q = wq x`` (H heads of nope + rope), ``[c ; k_pe] = wkv_a x``,
    ``c = kv_norm(c)``, ``[k_nope ; v] = wkv_b c`` (H heads of nope + v),
    ``q_pe`` and the heads' shared ``k_pe`` roped, scores scaled by
    ``scale`` (``head_dim^-0.5`` times YaRN's mscale squared), softmax in
    f32, ``wo`` over the H x v outputs. A prompt runs the expanded form
    (``forward``); a decode step runs the absorbed one over a ring of
    latents (``absorbed``). Tensor parallelism does not take it (``tp``
    stays None)."""

    tp = None

    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.cfg = cfg
        h, rope = cfg.n_heads, cfg.qk_rope_head_dim
        self.wq = nn.Linear(cfg.dim, h * cfg.head_dim, bias=False)
        self.wkv_a = nn.Linear(cfg.dim, cfg.kv_lora_rank + rope, bias=False)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.norm_eps)
        self.wkv_b = nn.Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               bias=False)
        self.wo = nn.Linear(h * cfg.v_head_dim, cfg.dim, bias=False)
        m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim \
            else 1.0
        self.scale = cfg.head_dim ** -0.5 * m * m
        self._absorbed = None

    def queries(self, h, cos, sin):
        """(q_nope (B, L, H, nope), q_pe (B, L, H, rope) roped) of normed ``h``."""
        cfg = self.cfg
        b, l, _ = h.shape
        q = linear_any(h, self.wq.weight).reshape(b, l, cfg.n_heads, cfg.head_dim)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
        return q_nope, apply_rope_halfsplit(q_pe, cos, sin)

    def latent(self, h, cos, sin):
        """(c (B, L, R) normed, k_pe (B, L, rope) roped): what the cache holds
        of each position."""
        cfg = self.cfg
        c, k_pe = linear_any(h, self.wkv_a.weight).split(
            [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
        k_pe = apply_rope_halfsplit(k_pe[:, :, None], cos, sin)[:, :, 0]
        return self.kv_norm(c), k_pe

    def forward(self, h, cos, sin, mask):
        """The expanded form over a prompt: normed ``h`` (B, L, D) -> (heads'
        outputs (B, L, H, v), (c, k_pe) for the cache). ``mask`` as
        ``ops.attention.sdpa``'s (bool keep, or additive), or None."""
        cfg = self.cfg
        b, l, _ = h.shape
        q_nope, q_pe = self.queries(h, cos, sin)
        c, k_pe = self.latent(h, cos, sin)
        kv = linear_any(c, self.wkv_b.weight).reshape(b, l, cfg.n_heads, -1)
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
        s = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
             + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float())) * self.scale
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF) if mask.dtype == torch.bool else s + mask
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(h.dtype), (c, k_pe)

    def absorb(self):
        """(W_uk (H, nope, R), W_uv (H, v, R)) in f32: ``wkv_b``'s key and
        value halves, kept until the weight changes."""
        w = self.wkv_b.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._absorbed is None or self._absorbed[0] != key:
            cfg = self.cfg
            wf = w.detach().float().reshape(cfg.n_heads, -1, cfg.kv_lora_rank)
            self._absorbed = (key, wf[:, :cfg.qk_nope_head_dim].contiguous(),
                              wf[:, cfg.qk_nope_head_dim:].contiguous())
        return self._absorbed[1:]

    def absorbed(self, q_nope, q_pe, ckv, bias):
        """One decode token a row in the absorbed form, in f32: q_nope (B, H,
        nope), q_pe (B, H, rope) roped; ckv (B, S, R + rope) the ring's
        latents and roped keys; bias (B, 1, S) f32, 0 where a slot counts and
        -inf where not. W_uk folds into the query, the scores run over the
        latents and the roped keys, W_uv applies after. Returns (B, H, v) in
        q_nope's dtype."""
        w_uk, w_uv = self.absorb()
        q = torch.cat([torch.einsum("bhn,hnr->bhr", q_nope.float(), w_uk), q_pe.float()],
                      dim=-1)
        kv = ckv.float()
        p = torch.softmax(torch.baddbmm(bias, q, kv.transpose(1, 2), alpha=self.scale), dim=-1)
        o_lat = torch.bmm(p, kv[..., :self.cfg.kv_lora_rank])
        return torch.einsum("bhr,hvr->bhv", o_lat, w_uv).to(q_nope.dtype)


class MoEFeedForward(nn.Module):
    """DeepSeek-V2's mixture of experts: ``p = softmax(gate x)`` in f32 over
    the E routed experts, the top k by p (not renormalised, times
    ``routed_scaling_factor``), ``y = sum_k p_k E_k(x) + S(x)`` with
    ``E_k(x) = W2_k (silu(W1_k x) * W3_k x)``; ``w13`` stacks each expert's
    W1 over its W3 (E, 2F, D), ``w2`` is (E, D, F); the shared experts are
    one SwiGLU of n_shared x F (``shared``). The sum runs in f32 and
    rounds once. A decode step's rows (``decode=True``, 1-8 of them) go
    through kernel K10 (``ops/kernels/moe_decode``), which reads the
    routing from device memory; a prompt's tokens are grouped by expert
    (one host sync a layer)."""

    def __init__(self, cfg: CodecLMConfig):
        super().__init__()
        self.cfg = cfg
        e, f, d = cfg.n_routed_experts, cfg.moe_hidden_dim, cfg.dim
        self.gate = nn.Linear(d, e, bias=False)
        self.w13 = nn.Parameter(torch.empty(e, 2 * f, d))
        self.w2 = nn.Parameter(torch.empty(e, d, f))
        self.shared = FeedForward(cfg, cfg.n_shared_experts * f) if cfg.n_shared_experts \
            else None

    def route(self, x):
        """x (N, D) -> (weights (N, k) f32, expert ids (N, k) int64), the
        largest probability first."""
        p = torch.softmax(linear(x.float(), self.gate.weight.float()), dim=-1)
        w, ids = torch.topk(p, self.cfg.n_experts_per_tok, dim=-1)
        if self.cfg.routed_scaling_factor != 1.0:
            w = w * self.cfg.routed_scaling_factor
        return w, ids

    def shared_weights(self):
        s = self.shared
        return (None, None, None) if s is None else (s.w1.weight, s.w3.weight, s.w2.weight)

    def forward(self, h, expert_load=None, decode: bool = False):
        """h (..., D) -> (..., D). ``decode``: the rows of one decode step,
        through K10, each routed slot tallied into ``expert_load`` (E,)
        int32 when given."""
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        w, ids = self.route(x)
        if decode:
            y = moe_decode(x, ids.to(torch.int32), w, self.w13, self.w2, *self.shared_weights(),
                           load=expert_load)
            return y.reshape(shape)
        return self.grouped(x, w, ids).reshape(shape)

    def grouped(self, x, w, ids):
        """The routed experts over a prompt's N tokens, grouped by expert (one
        host sync for the group sizes), each slot's output weighted, the k
        slots summed in f32 in a fixed order, the shared experts added, one
        rounding to x's dtype."""
        n, k = ids.shape
        f = self.cfg.moe_hidden_dim
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.bincount(flat, minlength=self.cfg.n_routed_experts).tolist()
        out = torch.zeros((n * k, x.shape[-1]), dtype=torch.float32, device=x.device)
        start = 0
        for e, m in enumerate(sizes):
            if not m:
                continue
            sel = order[start:start + m]
            start += m
            xe = x[sel // k]
            w13 = self.w13[e]
            u = F.silu(linear_any(xe, w13[:f])) * linear_any(xe, w13[f:])
            out[sel] = linear_any(u, self.w2[e]).float() * w.reshape(-1)[sel, None]
        y = out.reshape(n, k, -1).sum(dim=1)
        if self.shared is not None:
            y = y + self.shared(x).float()
        return y.to(x.dtype)


class TransformerBlock(nn.Module):
    """One pre-norm block: Mistral's, or with ``cfg.attention == "mla"`` and
    experts, DeepSeek-V2's (layer ``index`` dense below ``first_k_dense``)."""

    def __init__(self, cfg: CodecLMConfig, index: int = 0):
        super().__init__()
        self.cfg = cfg
        self.attention = MLAttention(cfg) if cfg.attention == "mla" else Attention(cfg)
        self.feed_forward = MoEFeedForward(cfg) if cfg.is_moe_layer(index) else FeedForward(cfg)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)

    def qkv(self, x, cos, sin):
        """Roped q and k and v, each (B, L, H, D); H is this rank's heads
        under tensor parallelism (the weights' rows, whole heads each)."""
        cfg, a = self.cfg, self.attention
        b, l, _ = x.shape
        h = self.attention_norm(x)
        q, k, v = (linear_any(h, w.weight) for w in (a.wq, a.wk, a.wv))
        q, k, v = (t.reshape(b, l, t.shape[-1] // cfg.head_dim, cfg.head_dim) for t in (q, k, v))
        return apply_rope_halfsplit(q, cos, sin), apply_rope_halfsplit(k, cos, sin), v

    def finish(self, x, attn, decode: bool = False, expert_load=None):
        """Out-projection residual (a row-parallel one reduced), then the FFN
        residual; ``decode`` (one token a row) sends an expert layer's rows
        through K10, tallying into ``expert_load``."""
        b, l = attn.shape[:2]
        o = linear_any(attn.reshape(b, l, -1), self.attention.wo.weight)
        x = x + (o if self.attention.tp is None else self.attention.tp.reduce(o))
        h = self.ffn_norm(x)
        if isinstance(self.feed_forward, MoEFeedForward):
            return x + self.feed_forward(h, expert_load, decode)
        return x + self.feed_forward(h)

    def forward(self, x, cos, sin, mask):
        """(x, the cache's per-layer state): (k, v) roped, or for latent
        attention (c, k_pe)."""
        if isinstance(self.attention, MLAttention):
            attn, state = self.attention(self.attention_norm(x), cos, sin, mask)
            return self.finish(x, attn), state
        q, k, v = self.qkv(x, cos, sin)
        return self.finish(x, sdpa(q, k, v, mask)), (k, v)


class MistralTransformer(nn.Module):
    """The decoder blocks, final norm and output head; ``remat`` (default
    ``layers.remat_default()``): per-layer rematerialization in training.
    ``tp``: the output head's vocabulary is sharded, its logits gathered."""

    tp = None

    def __init__(self, cfg: CodecLMConfig, remat: bool | None = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(TransformerBlock(cfg, i) for i in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.output = nn.Linear(cfg.dim, cfg.n_vocab, bias=False)
        self.remat = remat_default(remat)

    def rope(self, positions):
        """(cos, sin) of ``positions``: over head_dim, or for latent attention
        over the rope dims at YaRN's frequencies and magnitude (base 10000
        in both)."""
        cfg = self.cfg
        if cfg.attention != "mla":
            return rope_angles(positions, cfg.head_dim)
        inv = _yarn_freq(cfg.qk_rope_head_dim, ROPE_THETA, cfg.rope_factor,
                         cfg.rope_original_max_pos, cfg.rope_beta_fast, cfg.rope_beta_slow,
                         str(positions.device))
        cos, sin = rope_angles_freq(positions, inv)
        m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
             / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
        return cos, sin

    def forward(self, x, positions, mask=None):
        """x (bs, L, dim) embedded inputs -> (logits (bs, L, V), the cache's
        state per layer: (k, v), or (c, k_pe) for latent attention). With
        L > 1 and no mask, the banded causal mask is used."""
        cfg = self.cfg
        l = x.shape[1]
        cos, sin = self.rope(positions)
        if mask is None and l > 1:
            mask = banded_causal_mask(l, cfg.sliding_window, device=x.device)
        kvs = []
        for layer in self.layers:
            x, kv = run_layer(self.remat, layer, x, cos, sin, mask)
            kvs.append(kv)
        return self.head(x), kvs

    def head(self, x):
        """Final norm and output head: the (..., V) logits, on every rank."""
        y = linear_any(self.norm(x), self.output.weight)
        return y if self.tp is None else self.tp.gather(y)


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
    (default ``MARS5_TRAIN_REMAT``). ``tp``: a tensor-parallel decoder's
    copy (``parallel.tp.shard_module``) whose ``embed`` vocabulary is
    sharded."""

    tp = None

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
        self.expert_load = None      # models.ar_decode.expert_load's tally

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
        x = self.embed_ids(tokens)
        has_spk = spk_codes is not None or spk_vector is not None
        if has_spk:
            if spk_vector is None:
                spk_vector = self.spk_embedding(spk_codes)
            x = torch.cat([spk_vector[:, None].to(x.dtype), x], dim=1)
        logits, _ = self.ar(x, torch.arange(x.shape[1], device=x.device))
        return logits[:, 1:] if has_spk else logits

    def prefill(self, tokens, spk_vector):
        """(all logits incl. the speaker row, per-layer (k, v)) for decode."""
        x = self.embed_ids(tokens)
        x = torch.cat([spk_vector[:, None].to(x.dtype), x], dim=1)
        return self.ar(x, torch.arange(x.shape[1], device=x.device))

    def embed_ids(self, tokens):
        """``embed`` rows of ``tokens``, a vocabulary-parallel lookup under
        ``tp``."""
        if self.tp is None:
            return lookup(self.embed.weight, tokens)
        return self.tp.lookup(self.embed.weight, tokens)

    def init_(self, generator: torch.Generator) -> "CodecLM":
        """Seeded random init at any config (tests, benchmarks)."""
        init_params_(self, generator, embedding_names=(
            "embed.", "ref_chunked_emb.", "spk_identity_emb."))
        return self
