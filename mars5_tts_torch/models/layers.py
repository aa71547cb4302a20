"""Norm-first transformer encoder/decoder stacks with the SwiGLU FFN
(counterpart of ``mars5_tts_tpu/models/layers.py``, bf16/f32 path).

Module and parameter names follow torch's ``nn.TransformerEncoderLayer`` /
``nn.TransformerDecoderLayer`` as the reference patches them: ``linear1`` is
gone, the FFN lives in ``activation.{W,V}`` (silu(x W^T) * x V^T) and
``linear2``. Residual order (norm_first):

    encoder:  x += self_attn(norm1(x)); x += ff(norm2(x))
    decoder:  x += self_attn(norm1(x)); x += cross_attn(norm2(x), mem); x += ff(norm3(x))

and each stack ends with a LayerNorm (eps 4e-5).

Weights may be W8A8 (``ops/quant.py``). A quantized decoder layer runs the
serving path of the JAX package's ``decoder_layer_fused``
(:meth:`DecoderLayer.forward_w8a8`) over the fused sites its
:class:`NarOptions` name, or, with ``fused=False``, the JAX
``decoder_layer`` body with unfused W8A8 products; a quantized encoder layer
runs unfused W8A8 products. Given a ``MegaPack``, a quantized decoder stack
runs whole through kernel K9 (``ops/kernels/nar_mega.py``), the JAX
``MARS5_NAR_MEGA`` route.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import sdpa, torch_mha
from ..ops.kernels import mha as mha_kernel
from ..ops.kernels.nar_fused import fused_ffn, fused_linear
from ..ops.kernels.nar_mega import mega_decoder_stack
from ..ops.norms import layer_norm
from ..ops.quant import is_quantized, linear_any, slice_rows

LAYERNORM_EPS = 4e-5
NAR_SITES = ("qkv", "saout", "caq", "caout", "ffn")     # the W8A8 GEMM sites K3/K4 can run


@dataclass(frozen=True)
class NarOptions:
    """The NAR's routes, one to one with the JAX package's environment
    knobs: ``fused`` (``MARS5_NAR_FUSED``) the fused W8A8 decoder layer,
    over the GEMM ``sites`` (``MARS5_NARF_SITES``, a subset of NAR_SITES)
    that run in K3/K4 with activation groups of ``gsize`` columns
    (``MARS5_NARF_GSIZE``, 0 one a row); ``qattn`` (``MARS5_QATTN``) K1's
    int8 mode for attention with a quantized in-projection; ``cross_k1``
    (``MARS5_CROSS_PALLAS``) long-query cross-attention through K1. The
    last two act where the JAX package's ``torch_mha`` does: the encoder
    layers and the unfused decoder layer (the fused one calls K1 in bf16
    for its self-attention and plain attention across, as
    ``decoder_layer_fused`` does). ``sdpa_bf16`` (``MARS5_SDPA_BF16``):
    plain ``sdpa`` rounds a bf16 attention's scores to bf16 (False keeps
    them f32), in every NAR attention that does not take K1: the speaker
    encoder, the encoder, the decoder's cross-attention and its short
    self-attention."""
    fused: bool = True
    sites: tuple = ("qkv", "caq", "ffn")
    gsize: int = 0
    qattn: bool = False
    cross_k1: bool = False
    sdpa_bf16: bool = True

    def __post_init__(self):
        object.__setattr__(self, "sites", tuple(self.sites))
        bad = [s for s in self.sites if s not in NAR_SITES]
        if bad:
            raise ValueError(f"unknown NAR sites {bad}; expected a subset of {NAR_SITES}")
        if self.gsize < 0:
            raise ValueError(f"gsize must be >= 0, got {self.gsize}")

    def groups(self, k_dim: int) -> int:
        """Activation groups of a fused GEMM over ``k_dim`` columns (JAX
        ``gct``): one a row unless ``gsize`` divides ``k_dim``."""
        return k_dim // self.gsize if self.gsize and k_dim % self.gsize == 0 else 1


DEFAULT_OPTIONS = NarOptions()


def remat_default(remat: bool | None = None) -> bool:
    """A stack's ``remat``: as given, else ``MARS5_TRAIN_REMAT=1`` (the JAX
    package's switch of per-layer rematerialization)."""
    return os.environ.get("MARS5_TRAIN_REMAT", "0") == "1" if remat is None else bool(remat)


def run_layer(remat: bool, layer, *args):
    """``layer(*args)``; with ``remat`` while autograd records, under
    ``torch.utils.checkpoint`` (the JAX ``_maybe_remat``): the layer's
    activations are dropped after the forward and recomputed in the
    backward, so training holds one layer's activations instead of every
    layer's. Inference (no grad) runs the layer as it is."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class LayerNorm(nn.Module):
    """``weight``/``bias`` holder applied with ``ops.norms.layer_norm``."""

    def __init__(self, dim: int, eps: float = LAYERNORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class MultiheadAttention(nn.Module):
    """Parameters of torch's ``nn.MultiheadAttention`` (fused in-projection)."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, key_padding_mask=None, options: NarOptions = DEFAULT_OPTIONS):
        return torch_mha(self.in_proj_weight, self.in_proj_bias,
                         self.out_proj.weight, self.out_proj.bias,
                         q_in, kv_in, self.nhead, key_padding_mask,
                         qattn=options.qattn, cross_k1=options.cross_k1,
                         scores_bf16=options.sdpa_bf16)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.W = nn.Linear(dim, hidden, bias=False)
        self.V = nn.Linear(dim, hidden, bias=False)

    def forward(self, x):
        return F.silu(linear_any(x, self.W.weight)) * linear_any(x, self.V.weight)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, nhead: int, hidden: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nhead)
        self.activation = SwiGLU(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def ff(self, h):
        return linear_any(self.activation(h), self.linear2.weight, self.linear2.bias)

    def forward(self, x, key_padding_mask=None, options: NarOptions = DEFAULT_OPTIONS):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, key_padding_mask, options)
        return x + self.ff(self.norm2(x))


class DecoderLayer(EncoderLayer):
    def __init__(self, dim: int, nhead: int, hidden: int):
        super().__init__(dim, nhead, hidden)
        self.multihead_attn = MultiheadAttention(dim, nhead)
        self.norm3 = LayerNorm(dim)

    @property
    def is_quantized(self) -> bool:
        return is_quantized(self.activation.W.weight)

    def forward(self, x, memory, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, options: NarOptions = DEFAULT_OPTIONS):
        """The layer; a W8A8 one runs ``forward_w8a8`` when ``options.fused``,
        else the JAX ``decoder_layer`` body below with unfused products."""
        if self.is_quantized and options.fused:
            return self.forward_w8a8(x, memory, tgt_key_padding_mask,
                                     memory_key_padding_mask, options=options)
        h = self.norm1(x)
        x = x + self.self_attn(h, h, tgt_key_padding_mask, options)
        x = x + self.multihead_attn(self.norm2(x), memory, memory_key_padding_mask, options)
        return x + self.ff(self.norm3(x))

    def forward_w8a8(self, x, memory, tgt_key_padding_mask=None,
                     memory_key_padding_mask=None, q_start: int = 0,
                     options: NarOptions = DEFAULT_OPTIONS):
        """The W8A8 layer of the JAX package's ``decoder_layer_fused``: each
        GEMM site in ``options.sites`` through K3/K4, with
        ``options.groups(K)`` activation groups, the others LN +
        ``linear_any``. The default sites: qkv through K3 with the LN1
        prologue, K1 self-attention, the self-attention out-projection
        unfused, the cross-attention q through K3 with the LN2 prologue,
        plain cross-attention over the unfused K/V projection of the memory,
        its out-projection unfused, and the FFN through K4; ``saout`` and
        ``caout`` run the out-projections through K3 with the residual
        added in its epilogue. The JAX package takes the fused sites on a
        TPU only from 1024 rows up, for launch overhead there; the port
        always takes them (the same math).

        ``q_start > 0``: everything after the K/V projection runs on rows
        ``[q_start:]`` only, and the layer returns (B, L - q_start, D).
        """
        sites = options.sites
        b, l, d = x.shape
        g = options.groups(d)
        sa, ca = self.self_attn, self.multihead_attn
        nh = sa.nhead
        hd = d // nh
        w = sa.in_proj_weight
        if "qkv" in sites:
            qkv = fused_linear(x, (w.q, w.scales), ln=(self.norm1.weight, self.norm1.bias),
                               bias=sa.in_proj_bias, eps=self.norm1.eps, groups=g)
        else:
            qkv = linear_any(self.norm1(x), w, sa.in_proj_bias)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, l, nh, hd) for i in range(3))
        if q_start:
            q, x = q[:, q_start:], x[:, q_start:]
            l -= q_start
        a = mha_kernel.mha(q, k, v, tgt_key_padding_mask).reshape(b, l, d)
        w = sa.out_proj.weight
        if "saout" in sites:
            x = fused_linear(a, (w.q, w.scales), bias=sa.out_proj.bias, residual=x.contiguous(),
                             groups=g)
        else:
            x = x + linear_any(a, w, sa.out_proj.bias)

        w = ca.in_proj_weight
        if "caq" in sites:
            wq = slice_rows(w, 0, d)
            hq = fused_linear(x, (wq.q, wq.scales), ln=(self.norm2.weight, self.norm2.bias),
                              bias=ca.in_proj_bias[:d], eps=self.norm2.eps, groups=g)
        else:
            hq = linear_any(self.norm2(x), slice_rows(w, 0, d), ca.in_proj_bias[:d])
        kv = linear_any(memory, slice_rows(w, d, 3 * d), ca.in_proj_bias[d:])
        lk = kv.shape[1]
        mask = (None if memory_key_padding_mask is None
                else ~memory_key_padding_mask[:, None, None, :])
        c = sdpa(hq.reshape(b, l, nh, hd), kv[..., :d].reshape(b, lk, nh, hd),
                 kv[..., d:].reshape(b, lk, nh, hd), mask,
                 scores_bf16=options.sdpa_bf16).reshape(b, l, d)
        w = ca.out_proj.weight
        if "caout" in sites:
            x = fused_linear(c.contiguous(), (w.q, w.scales), bias=ca.out_proj.bias,
                             residual=x.contiguous(), groups=g)
        else:
            x = x + linear_any(c, w, ca.out_proj.bias)

        if "ffn" not in sites:
            return x + self.ff(self.norm3(x))
        W, V, l2 = self.activation.W.weight, self.activation.V.weight, self.linear2.weight
        return fused_ffn(x, (self.norm3.weight, self.norm3.bias), (W.q, W.scales),
                         (V.q, V.scales), (l2.q, l2.scales), self.linear2.bias,
                         eps=self.norm3.eps, groups=g, groups2=options.groups(l2.q.shape[1]))


class TransformerEncoder(nn.Module):
    """Encoder layers + final LayerNorm; ``remat`` (default
    ``remat_default()``): per-layer rematerialization in training."""

    def __init__(self, dim: int, nhead: int, hidden: int, n_layers: int,
                 remat: bool | None = None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(dim, nhead, hidden)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(dim)
        self.remat = remat_default(remat)

    def forward(self, x, key_padding_mask=None, options: NarOptions = DEFAULT_OPTIONS):
        for layer in self.layers:
            x = run_layer(self.remat, layer, x, key_padding_mask, options)
        return self.norm(x)


class TransformerDecoder(nn.Module):
    """Decoder layers + final LayerNorm; ``remat`` as ``TransformerEncoder``'s."""

    def __init__(self, dim: int, nhead: int, hidden: int, n_layers: int,
                 remat: bool | None = None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(dim, nhead, hidden)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(dim)
        self.remat = remat_default(remat)

    def forward(self, x, memory, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, q_tail_start: int = 0, mega=None,
                options: NarOptions = DEFAULT_OPTIONS):
        """Stacked decoder layers + final LayerNorm. ``q_tail_start > 0`` returns
        only rows from that index on, (B, L - q_tail_start, D); a fused W8A8
        stack then runs its last layer past the K/V projection on those rows
        only (the unfused one, as the JAX ``decoder_stack``, slices at the
        end). ``options``: the layers' routes (:class:`NarOptions`).

        ``mega``: this stack's ``build_mega_pack``; the layers then run as one
        K9 call over every row (as the JAX package's mega route does), the
        final LayerNorm after it, and the slice last."""
        if mega is not None:
            x = self.norm(mega_decoder_stack(mega, x, memory, tgt_key_padding_mask,
                                             memory_key_padding_mask,
                                             eps=self.layers[0].norm1.eps))
            return x[:, q_tail_start:] if q_tail_start else x
        last = self.layers[-1]
        sliced = bool(q_tail_start) and last.is_quantized and options.fused
        for layer in self.layers[:-1] if sliced else self.layers:
            x = run_layer(self.remat, layer, x, memory, tgt_key_padding_mask,
                          memory_key_padding_mask, options)
        if sliced:
            return self.norm(last.forward_w8a8(x, memory, tgt_key_padding_mask,
                                               memory_key_padding_mask, q_tail_start,
                                               options))
        x = self.norm(x)
        return x[:, q_tail_start:] if q_tail_start else x


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator,
                 embedding_names: tuple = ()) -> None:
    """Seeded init matching the JAX package's ``init_*`` distributions:
    matrices U(-1/sqrt(fan_in), 1/sqrt(fan_in)), tables named in
    ``embedding_names`` N(0, 1), norm weights and ``alpha`` scalars 1, biases 0.
    Draws are made in f32 on the parameter's device, then cast."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if any(name.startswith(e) for e in embedding_names):
            w = torch.empty(p.shape, device=p.device).normal_(generator=generator)
        elif leaf == "alpha" or (leaf == "weight" and p.ndim == 1):
            w = torch.ones(p.shape)
        elif leaf == "bias" or leaf.endswith("_bias"):
            w = torch.zeros(p.shape)
        else:
            s = p.shape[-1] ** -0.5
            w = torch.empty(p.shape, device=p.device).uniform_(-s, s, generator=generator)
        p.copy_(w)
