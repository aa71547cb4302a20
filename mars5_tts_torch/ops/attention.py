"""Attention ops (counterpart of ``mars5_tts_tpu/ops/attention.py``).

Linear kernels keep torch's (out, in) layout. Softmax always runs in f32.
"""

from __future__ import annotations

import math

import torch

from .kernels import mha as mha_kernel
from .quant import is_quantized, linear_any, slice_rows

NEG_INF = float("-inf")

# attention with at least this many queries goes to kernel K1 on CUDA, the
# same threshold at which the JAX package takes its Pallas kernel on TPU
KERNEL_SELF_ATTN_MIN_LEN = 512


def kernel_route(t) -> bool:
    """Whether attention over tensors like ``t`` takes kernel K1's route
    (given the length conditions of ``torch_mha``): on the card, as the JAX
    package takes its Pallas kernel only on a TPU (``ops.pallas.enabled``)."""
    return t.is_cuda


def linear(x, w, b=None):
    """y = x @ w.T (+ b): f32 accumulation, one rounding to x's dtype, then the
    bias added in that dtype (as ``jax.lax.dot_general`` with
    ``preferred_element_type=f32`` followed by ``.astype``)."""
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def sdpa(q, k, v, mask=None):
    """Scaled dot-product attention, q (B, Lq, H, D), k/v (B, Lk, H, D).

    ``mask`` broadcasts to (B, H, Lq, Lk): bool (True = keep) or additive
    (0 / -inf). bf16 inputs round the scaled scores to bf16 before the mask and
    the f32 softmax, as the JAX serving path does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if q.dtype == torch.bfloat16:
        logits = logits.to(torch.bfloat16)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
    return out.to(q.dtype)


def torch_mha(in_w, in_b, out_w, out_b, q_in, kv_in, nhead: int,
              key_padding_mask=None, *, qattn: bool = False, cross_k1: bool = False):
    """torch ``nn.MultiheadAttention`` forward (batch_first).

    in_w (3D, D) / in_b (3D,) are torch's fused in-projection; out_w/out_b the
    out-projection (any of them may be a ``QuantWeight``, which then runs
    W8A8). key_padding_mask (B, Lk) bool, True = ignore. Attention with at
    least ``KERNEL_SELF_ATTN_MIN_LEN`` queries and Lq == Lk, or any Lk with
    ``cross_k1`` (JAX ``MARS5_CROSS_PALLAS``), takes kernel K1's route
    (``kernel_route``: CUDA tensors), in its int8 mode with ``qattn`` (JAX
    ``MARS5_QATTN``) when the in-projection is quantized; plain ``sdpa``
    otherwise.
    """
    d = q_in.shape[-1]
    b, lq = q_in.shape[:2]
    lk = kv_in.shape[1]
    if q_in is kv_in:
        qkv = linear_any(q_in, in_w, in_b)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q = linear_any(q_in, slice_rows(in_w, 0, d), in_b[:d])
        kv = linear_any(kv_in, slice_rows(in_w, d, 3 * d), in_b[d:])
        k, v = kv[..., :d], kv[..., d:]
    q = q.reshape(b, lq, nhead, d // nhead)
    k = k.reshape(b, lk, nhead, d // nhead)
    v = v.reshape(b, lk, nhead, d // nhead)
    if lq >= KERNEL_SELF_ATTN_MIN_LEN and (lq == lk or cross_k1) and kernel_route(q):
        out = mha_kernel.mha(q, k, v, key_padding_mask,
                             quantized=qattn and is_quantized(in_w))
    else:
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        out = sdpa(q, k, v, mask)
    return linear_any(out.reshape(b, lq, d), out_w, out_b)


def banded_causal_mask(length: int, window: int, device=None, dtype=torch.float32):
    """Additive (L, L) mask: row i attends to j in [i - window, i]."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    allowed = (j <= i) & (j >= i - window)
    return torch.where(allowed, 0.0, NEG_INF).to(dtype)
