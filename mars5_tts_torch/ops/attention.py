"""Attention ops (counterpart of ``mars5_tts_tpu/ops/attention.py``).

Linear kernels keep torch's (out, in) layout. Softmax always runs in f32.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import is_dtensor
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
    ``preferred_element_type=f32`` followed by ``.astype``). A DTensor
    product (tensor-parallel training) that is not a partial sum passes
    through ``_whole_grad``."""
    y = torch.matmul(x, w.t())
    if is_dtensor(y) and not any(p.is_partial() for p in y.placements):
        y = _whole_grad(y)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _whole_grad(x):
    """``x`` unchanged, its gradient brought to ``x``'s own placements
    before it goes on into the product that made ``x``. DTensor's backward
    may otherwise hand a product a gradient sharded over tp along the
    sequence, which the product's reshape of (B, L, N) to (B L, N) refuses
    once L does not split evenly (7 frames over tp = 4)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(grad_placements=x.placements), x.device_mesh,
                              x.placements, run_check=False)


def sdpa(q, k, v, mask=None, scores_bf16: bool = True):
    """Scaled dot-product attention, q (B, Lq, H, D), k/v (B, Lk, H, D).

    ``mask`` broadcasts to (B, H, Lq, Lk): bool (True = keep) or additive
    (0 / -inf). bf16 inputs round the scaled scores to bf16 before the mask and
    the f32 softmax, as the JAX serving path does, unless ``scores_bf16`` is
    False (the JAX ``MARS5_SDPA_BF16=0``). DTensor inputs (a sharded
    training step) attend a shard at a time (``_sdpa_shards``).
    """
    if is_dtensor(q):
        return _sdpa_shards(q, k, v, mask)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if q.dtype == torch.bfloat16 and scores_bf16:
        logits = logits.to(torch.bfloat16)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
    return out.to(q.dtype)


def _sdpa_shards(q, k, v, mask):
    """``sdpa`` of DTensors on each device's shard: batch rows (``dp``) and
    heads (``tp``) never meet in attention, so it needs no collective (and
    none of DTensor's view rules for the einsums, which older PyTorch
    refuses on a sharded head dim). k, v and a batched mask are first
    placed like q's rows and heads."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    mesh, placements = q.device_mesh, q.placements
    k, v = (t.redistribute(mesh, placements) for t in (k, v))
    if mask is not None and mask.ndim == 4:         # (B, 1, 1, Lk): the rows of q's
        rows = tuple(p if p.is_shard(0) else Replicate() for p in placements)
        mask = (mask.redistribute(mesh, rows) if is_dtensor(mask)
                else distribute_tensor(mask, mesh, rows, src_data_rank=None)).to_local()
    elif is_dtensor(mask):
        mask = mask.full_tensor()
    out = sdpa(q.to_local(), k.to_local(), v.to_local(), mask)
    return DTensor.from_local(out, mesh, placements, run_check=False)


def _thirds(t):
    """The q, k and v thirds of a DTensor in-projection weight (3D, D) or
    bias (3D,), each a DTensor. ``parallel.sharding`` places it
    ``_StridedShard(0, split_factor=3)`` (or replicates it), so each
    device's rows are the same heads of each third: third i is the i-th
    third of every device's rows, placed ``Shard(0)``. Built from the local
    rows, as DTensor's view rules of some PyTorch versions refuse
    ``view(3, D, D)`` of a strided shard."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    placements = tuple(Shard(0) if isinstance(p, _StridedShard) or p.is_shard(0) else p
                       for p in t.placements)
    local = t.to_local()
    parts = local.view(3, local.shape[0] // 3, *local.shape[1:])
    return [DTensor.from_local(parts[i], t.device_mesh, placements, run_check=False)
            for i in range(3)]


def torch_mha(in_w, in_b, out_w, out_b, q_in, kv_in, nhead: int,
              key_padding_mask=None, *, qattn: bool = False, cross_k1: bool = False,
              scores_bf16: bool = True, tp=None):
    """torch ``nn.MultiheadAttention`` forward (batch_first).

    in_w (3D, D) / in_b (3D,) are torch's fused in-projection; out_w/out_b the
    out-projection (any of them may be a ``QuantWeight``, which then runs
    W8A8). key_padding_mask (B, Lk) bool, True = ignore. Attention with at
    least ``KERNEL_SELF_ATTN_MIN_LEN`` queries and Lq == Lk, or any Lk with
    ``cross_k1`` (JAX ``MARS5_CROSS_PALLAS``), takes kernel K1's route
    (``kernel_route``: CUDA tensors) where the head dim is K1's 64 (a
    DeepSeek-V2 AR's speaker encoder has heads of 128), in its int8 mode with ``qattn`` (JAX
    ``MARS5_QATTN``) when the in-projection is quantized; plain ``sdpa``
    otherwise, its scores rounded as ``scores_bf16`` says. A DTensor in-projection (tensor-parallel training) is
    projected a third at a time. ``tp`` (``parallel.tp.TensorParallel``,
    tensor-parallel decoding): in_w / in_b hold this rank's heads of each
    third (3E rows, E = D / tp), out_w its E columns; K1 or ``sdpa`` runs
    on those heads and the out-projection's partial sums are reduced, its
    bias added once after.
    """
    d = q_in.shape[-1]
    e = in_b.shape[0] // 3              # D, or this rank's E under tp
    b, lq = q_in.shape[:2]
    lk = kv_in.shape[1]
    if is_dtensor(in_w):
        # tensor-parallel training (parallel/sharding.py): each third of the
        # in-projection is sharded head-aligned, so project q, k and v apart
        w3, b3 = _thirds(in_w), _thirds(in_b)
        q = linear(q_in, w3[0], b3[0])
        k, v = (linear(kv_in, w3[i], b3[i]) for i in (1, 2))
    elif q_in is kv_in:
        qkv = linear_any(q_in, in_w, in_b)
        q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    else:
        q = linear_any(q_in, slice_rows(in_w, 0, e), in_b[:e])
        kv = linear_any(kv_in, slice_rows(in_w, e, 3 * e), in_b[e:])
        k, v = kv[..., :e], kv[..., e:]
    hd = d // nhead
    q = q.reshape(b, lq, e // hd, hd)
    k = k.reshape(b, lk, e // hd, hd)
    v = v.reshape(b, lk, e // hd, hd)
    if (lq >= KERNEL_SELF_ATTN_MIN_LEN and (lq == lk or cross_k1) and hd == mha_kernel.HEAD_DIM
            and kernel_route(q)):
        out = mha_kernel.mha(q, k, v, key_padding_mask,
                             quantized=qattn and is_quantized(in_w))
    else:
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        out = sdpa(q, k, v, mask, scores_bf16=scores_bf16)
    if tp is None:
        return linear_any(out.reshape(b, lq, e), out_w, out_b)
    return tp.reduce(linear_any(out.reshape(b, lq, e), out_w), out_b)


def banded_causal_mask(length: int, window: int, device=None, dtype=torch.float32):
    """Additive (L, L) mask: row i attends to j in [i - window, i]."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    allowed = (j <= i) & (j >= i - window)
    return torch.where(allowed, 0.0, NEG_INF).to(dtype)
