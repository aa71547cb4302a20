"""The quantized AR decode step, kernel K2 ``fused_decode_layers``
(``csrc/decode_layer.cu``), its plain twin ``fused_step_ref``, and the pack
both read.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/decode_layer.py::
_make_kernel`` (entry ``fused_decode_layers``): one generated token of each
of B = 1..8 rows through every layer of the AR backbone, each row at its own
position (its own RoPE angles, ring validity and self column), the weight
stream shared by the rows. Per layer: RMSNorm, per-token
int8 activation quant, the W8A8 (``wbits=8``) or W4A8 (``wbits=4``,
nibble-packed) q/k/v projections, the half-split RoPE on a flat row, ring
attention over an int8 KV cache with per-position scales and an explicit
column for the current token, the wo projection and residual, then RMSNorm,
w1/w3, ``silu(w1 x) * w3 x``, w2 and the residual. It returns the
pre-final-norm hidden row and the new K/V rows in f32; the caller quantizes
them into the cache (``quantize_kv_rows``).

The pack (``build_fused_pack``) keeps every matrix in torch's (out, in)
layout with per-row f32 scales: per layer ``wqkv`` (3d, d), ``wo`` (d, d),
``w13`` (2 hidden, d) and ``w2`` (d, hidden). At ``wbits=4`` each byte holds
two int4 values of one row, the low nibble from the left half of the input
axis and the high nibble from the right half, both sign-extended; wq..w3
keep one scale per half (scale rows 0 and 1), w2 one scale per row. The
JAX package stores w2 transposed with its nibble pairs along the output
axis; the integer sums are exact, so pairing along the input axis gives the
same result (``models/convert.fused_pack_from_jax`` converts its pack).

What bounds K2 on an H100: the weight stream. At the released widths
(26 x 1536, hidden 3584) the pack is 675 MB a step at W8 and 337 MB at W4,
whatever the number of rows, plus the int8 K/V of each row's positions so
far (3 KB a position and layer). The products are GEMVs (B <= 8 activation
rows), far below the tensor cores' break-even, so the kernel streams each
weight row once with 16-byte loads, one warp per output row, and dots it
with every activation row with ``__dp4a``. See the CUDA source for the
launch sequence.

Numerics, those of ``fused_step_emulation``: ``xs = max(amax, 1e-8) / 127``
and ``q = rint(x / xs)`` clipped to +-127; the W8 rescale ``(acc * xs) *
ws``, the W4 one ``(ya * sA + yb * sB) * xs``; attention scores
``((acc * qms) * ks) * scale`` with -inf on invalid slots, the current
token's score from the unquantized f32 q and k, ``p * vs`` quantized per
head over all slots, the PV product times ``ps`` and divided by the
softmax denominator, plus ``(p_self / denom) * v``; w2 sums both halves of
``u`` in int32 before ``(acc * us) * w2s``. The f32 sums (the RMS mean, the
self score, the softmax denominator) accumulate in f64 and round once, so
kernel and twin get the same value in any order; the integer products are
exact. Against the JAX package, whose XLA sums run in f32 in its own order
and whose ``cos``/``sin`` differ in the last ulp, one int8 rounding can move
now and then (ROADMAP C).

The rows are independent: row b of a batched step is the step of row b
alone (the JAX ``fused_step_emulation_batched`` is per-row emulations).
Caches are (L, B, W_pad, d) int8 with scales (L, B, 2, W_pad) (row 0 K, row
1 V); a one-row step also takes the (L, W_pad, d) / (L, 2, W_pad) forms.

``fused_decode_layers`` takes the twin only for CPU tensors. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..quant import div, int8_matmul, quantize_act, quantize_weight, quantize_weight_mse
from ..rope import apply_rope_halfsplit, rope_angles
from ...utils.device import ints_on_device
from . import build

SOURCES = build.LIBRARIES["decode_layer"]
HEAD_DIM = 64          # the attention kernel's head width
MAX_ROW_BYTES = 4096   # a weight row a warp holds in registers (16 B x 8 a lane)
MAX_BATCH = 8          # activation rows a step takes
GEMV_SMEM = 48 * 1024  # a GEMV block's shared memory: K f32 + B x K int8 + B scales

# Launches of the CUDA kernel in this process (reset with reset_launch_count).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


@dataclass(frozen=True)
class FusedDims:
    """Static geometry of the quantized decode step."""

    n_layers: int
    dim: int
    hidden: int
    n_heads: int
    head_dim: int
    window: int      # ring slots: min(sliding_window, max_len + 1)
    wbits: int = 8   # 8 (int8 weights) or 4 (nibble-packed int4)
    batch: int = 1   # rows the batched engine decodes a step (<= MAX_BATCH)


def make_dims(cfg, max_len: int, wbits: int = 8, batch: int = 1) -> FusedDims:
    """The geometry for ``cfg`` decoding up to ``max_len`` tokens in
    ``batch`` rows. The pack (batch-independent) needs dim = n_heads *
    head_dim, a multiple of 128, and hidden / 2 a multiple of 128 (the JAX
    pack's constraints)."""
    if wbits not in (4, 8):
        raise ValueError(f"wbits must be 8 or 4, got {wbits}")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"the fused decode batch must be in [1, {MAX_BATCH}], got {batch}")
    if cfg.dim != cfg.n_heads * cfg.head_dim or cfg.n_kv_heads != cfg.n_heads:
        raise ValueError("the fused decode step needs dim = n_heads * head_dim "
                         "and n_kv_heads = n_heads")
    if cfg.dim % 128 or cfg.hidden_dim % 256:
        raise ValueError(f"the fused pack needs dim and hidden/2 multiples of 128, "
                         f"got dim {cfg.dim}, hidden {cfg.hidden_dim}")
    return FusedDims(n_layers=cfg.n_layers, dim=cfg.dim, hidden=cfg.hidden_dim,
                     n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                     window=min(cfg.sliding_window, max_len + 1), wbits=wbits,
                     batch=batch)


# ------------------------------------------------------------------ the pack

def pack4(qa, qb):
    """Two int8-valued int4 matrices -> one byte each pair: low nibble from
    ``qa``, high nibble from ``qb``."""
    b = ((qb.to(torch.int32) & 15) << 4) | (qa.to(torch.int32) & 15)
    return (b - ((b & 128) << 1)).to(torch.int8)


def unpack4(b):
    """Inverse of ``pack4``: packed int8 -> (low, high) sign-extended int8."""
    w = b.to(torch.int32)
    return (((w & 15) ^ 8) - 8).to(torch.int8), (w >> 4).to(torch.int8)


def _q8(w):
    q, s = quantize_weight(w)
    return q, s[None]


def _q4(w):
    """(out, in) -> packed (out, in/2), scales (2, out): each half of the
    input axis quantized on its own with the int4 clip search."""
    h = w.shape[-1] // 2
    qa, sa = quantize_weight_mse(w[:, :h], levels=7)
    qb, sb = quantize_weight_mse(w[:, h:], levels=7)
    return pack4(qa, qb), torch.stack([sa, sb])


def build_fused_pack(codeclm, dims: FusedDims) -> dict:
    """Quantize the backbone of a port ``CodecLM`` into the K2 pack (see the
    module docstring); int8 tensors and f32 scales on the model's device."""
    quant = _q4 if dims.wbits == 4 else _q8
    cols = {k: [] for k in ("wqkv", "sqkv", "wo", "so", "w13", "s13", "w2", "s2")}
    for layer in codeclm.ar.layers:
        a, f = layer.attention, layer.feed_forward
        for name, w in (("qkv", torch.cat([a.wq.weight, a.wk.weight, a.wv.weight])),
                        ("o", a.wo.weight),
                        ("13", torch.cat([f.w1.weight, f.w3.weight]))):
            q, s = quant(w.detach())
            cols["w" + name].append(q)
            cols["s" + name].append(s.float())
        w2 = f.w2.weight.detach()
        if dims.wbits == 4:
            q, s = quantize_weight_mse(w2, levels=7)
            h = q.shape[1] // 2
            q = pack4(q[:, :h], q[:, h:])
        else:
            q, s = quantize_weight(w2)
        cols["w2"].append(q)
        cols["s2"].append(s.float())
    fp = {k: torch.stack(v).contiguous() for k, v in cols.items()}
    for name, attr in (("attn_norms", "attention_norm"), ("ffn_norms", "ffn_norm")):
        fp[name] = torch.stack([getattr(layer, attr).weight.detach().float()
                                for layer in codeclm.ar.layers]).contiguous()
    return fp


def quantize_kv_rows(x):
    """Per-position int8 K/V: (..., d) -> (q int8 (..., d), scales (...,) f32)."""
    q, s = quantize_act(x)
    return q, s[..., 0]


def rope_flat(pos: int, dims: FusedDims, device):
    """(cos, sin), each (head_dim / 2,) f32, of position ``pos``: the angles of
    the JAX package's flat layout ``[cos | cos]`` per head, kept once."""
    cos, sin = rope_angles(torch.full((1,), pos, device=device), dims.head_dim)
    return cos[0], sin[0]


def rope_rows(positions, dims: FusedDims, device):
    """(cos, sin), each (B, head_dim / 2): ``rope_flat`` of each row."""
    cs = [rope_flat(p, dims, device) for p in positions]
    return torch.stack([c for c, _ in cs]), torch.stack([s for _, s in cs])


def positions_of(pos, rows: int) -> list[int]:
    """``pos`` (an int or ``rows`` ints) as a list of ``rows`` ints."""
    p = [int(v) for v in torch.as_tensor(pos).reshape(-1).tolist()]
    return p * rows if len(p) == 1 else p


def as_batched(cache_k, cache_v, kv_scales):
    """The (L, B, W_pad, d) / (L, B, 2, W_pad) forms of a cache, from the
    one-row (L, W_pad, d) / (L, 2, W_pad) forms (views)."""
    if cache_k.ndim == 3:
        return cache_k[:, None], cache_v[:, None], kv_scales[:, None]
    return cache_k, cache_v, kv_scales


# --------------------------------------------------------------- plain twin

def _sum(x):
    """f32 sum over the last axis, accumulated in f64 and rounded once: the
    same f32 value in any order, so the kernel's block reduction gives it too."""
    return x.double().sum(dim=-1, keepdim=True).float()


def _rms_quant(h, w, eps):
    r = 1.0 / torch.sqrt(div(_sum(h * h), h.shape[-1]) + eps)
    return quantize_act(h * r * w)


def _dot(xq, xs, w, s, w4: bool):
    """One quantized row times a pack matrix -> (1, N) f32, the kernel's
    epilogue order."""
    if w4:
        lo, hi = unpack4(w)
        k2 = xq.shape[-1] // 2
        ya = int8_matmul(xq[:, :k2].contiguous(), lo).float()
        yb = int8_matmul(xq[:, k2:].contiguous(), hi).float()
        return (ya * s[0] + yb * s[1]) * xs
    return int8_matmul(xq, w).float() * xs * s[0]


def _int_sum_w2(uq, w, w4: bool):
    if w4:
        lo, hi = unpack4(w)
        k2 = uq.shape[-1] // 2
        return int8_matmul(uq[:, :k2].contiguous(), lo) + int8_matmul(uq[:, k2:].contiguous(), hi)
    return int8_matmul(uq, w)


def _ring_valid(pos: int, window: int, n_slots: int, device):
    slots = torch.arange(n_slots, device=device)
    return ((pos - torch.remainder(pos - slots, window) >= 0) & (slots < window)
            & (slots != pos % window))


def _self_scores(qh, kh, scale):
    """The current token's score per head from the unquantized f32 q and k."""
    return _sum(qh * kh) * scale


def _attention(q, k_new, v, ck, cv, ks, vs, valid, dims: FusedDims):
    """One token's ring attention over int8 K/V, per head; q, k_new, v (1, d)
    f32 (q, k roped); ck/cv (W_pad, d) int8; ks/vs (W_pad,) f32 -> (1, d)."""
    H, Dh = dims.n_heads, dims.head_dim
    scale = 1.0 / math.sqrt(Dh)
    qh, kh, vh = q.view(H, Dh), k_new.view(H, Dh), v.view(H, Dh)
    q8, qms = quantize_act(qh)                                     # (H, Dh), (H, 1)
    kc = ck.view(-1, H, Dh).double()
    acc = torch.einsum("hd,whd->hw", q8.double(), kc)              # exact
    scores = acc.float() * qms * ks[None, :] * scale
    scores = scores.masked_fill(~valid[None, :], float("-inf"))
    self_s = _self_scores(qh, kh, scale)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), self_s)
    p = torch.exp(scores - m)
    p_self = torch.exp(self_s - m)
    denom = _sum(p) + p_self
    pv8, ps = quantize_act(p * vs[None, :])
    out = torch.einsum("hw,whd->hd", pv8.double(), cv.view(-1, H, Dh).double()).float() * ps
    return (out / denom + (p_self / denom) * vh).reshape(1, -1)


@torch.no_grad()
def fused_step_ref(fp, x, pos, cache_k, cache_v, kv_scales, *, dims: FusedDims,
                   norm_eps: float = 1e-5):
    """Plain version of K2 (the JAX package's ``fused_step_emulation_batched``,
    one ``fused_step_emulation`` with ``quantized=True`` a row).

    x (B, d) embedded tokens (bf16); pos an int or B ints; cache_k/cache_v
    (L, B, W_pad, d) int8 with W_pad >= window (slots past the window are
    ignored); kv_scales (L, B, 2, W_pad) f32 (row 0 K, row 1 V); one row may
    pass (L, W_pad, d) / (L, 2, W_pad). Returns (h (B, d) f32 before the
    final norm, k_new (L, B, d) f32 roped, v_new (L, B, d) f32)."""
    w4 = dims.wbits == 4
    B, d = x.shape[0], dims.dim
    cache_k, cache_v, kv_scales = as_batched(cache_k, cache_v, kv_scales)
    positions = positions_of(pos, B)
    cos, sin = rope_rows(positions, dims, x.device)
    cos, sin = cos[:, None], sin[:, None]                       # (B, 1, Dh/2)
    valid = [_ring_valid(p, dims.window, cache_k.shape[2], x.device) for p in positions]
    h = x.float().reshape(B, d)
    k_news, v_news = [], []
    heads = (B, dims.n_heads, dims.head_dim)
    for l in range(dims.n_layers):
        xq, xs = _rms_quant(h, fp["attn_norms"][l], norm_eps)
        qkv = _dot(xq, xs, fp["wqkv"][l], fp["sqkv"][l], w4)
        q = apply_rope_halfsplit(qkv[:, :d].reshape(heads), cos, sin).reshape(B, d)
        k = apply_rope_halfsplit(qkv[:, d:2 * d].reshape(heads), cos, sin).reshape(B, d)
        v = qkv[:, 2 * d:]
        k_news.append(k)
        v_news.append(v)
        attn = torch.cat([_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], cache_k[l, b],
                                     cache_v[l, b], kv_scales[l, b, 0], kv_scales[l, b, 1],
                                     valid[b], dims) for b in range(B)])
        aq, as_ = quantize_act(attn)
        h = h + _dot(aq, as_, fp["wo"][l], fp["so"][l], w4)
        xq, xs = _rms_quant(h, fp["ffn_norms"][l], norm_eps)
        ab = _dot(xq, xs, fp["w13"][l], fp["s13"][l], w4)
        a, b_ = ab[:, :dims.hidden], ab[:, dims.hidden:]
        uq, us = quantize_act(a * (1.0 / (1.0 + torch.exp(-a))) * b_)
        h = h + _int_sum_w2(uq, fp["w2"][l], w4).float() * us * fp["s2"][l]
    return h, torch.stack(k_news), torch.stack(v_news)


# ------------------------------------------------------------------- kernel

def _lib():
    lib = build.load("decode_layer", SOURCES)
    fn = lib.mars5_fused_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # wbits, B, L, d, hidden, n_heads, window, w_pad, eps, x, pos, cos, sin,
        # wqkv, sqkv, wo, so, w13, s13, w2, s2, attn_norms, ffn_norms,
        # cache_k, cache_v, kv_scales, h, k_new, v_new, scratch, stream
        fn.argtypes = [i] * 8 + [ctypes.c_float] + [vp] * 22
        fn.restype = ctypes.c_int
    return fn


def _need(t, dtype, shape, what):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda:
        raise ValueError(f"fused_decode_layers: {what} must be a CUDA {dtype} tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_decode_layers: {what} must be contiguous and 16-byte aligned")


def check_pack(fp, dims: FusedDims) -> None:
    """Raise unless the pack has the dtypes and shapes the kernel reads."""
    L, d, f = dims.n_layers, dims.dim, dims.hidden
    g, div = (2, 2) if dims.wbits == 4 else (1, 1)
    for name, shape, dtype in (("wqkv", (L, 3 * d, d // div), torch.int8),
                               ("sqkv", (L, g, 3 * d), torch.float32),
                               ("wo", (L, d, d // div), torch.int8),
                               ("so", (L, g, d), torch.float32),
                               ("w13", (L, 2 * f, d // div), torch.int8),
                               ("s13", (L, g, 2 * f), torch.float32),
                               ("w2", (L, d, f // div), torch.int8),
                               ("s2", (L, d), torch.float32),
                               ("attn_norms", (L, d), torch.float32),
                               ("ffn_norms", (L, d), torch.float32)):
        _need(fp[name], dtype, shape, name)


def fused_decode_layers(fp, x, pos, cache_k, cache_v, kv_scales, *,
                        dims: FusedDims, norm_eps: float = 1e-5):
    """K2: one decode token of each of B rows through every layer -> (h (B, d)
    f32, k_new (L, B, d) f32, v_new (L, B, d) f32); arguments as
    ``fused_step_ref``.

    CPU tensors take ``fused_step_ref``. CUDA tensors launch the kernel and
    raise on what it does not take: x bf16 (B, d) with 1 <= B <= 8,
    positions >= 0, head_dim 64, weight rows of at most 4096 bytes, a pack as
    ``build_fused_pack`` makes it."""
    if x.device.type == "cpu":
        return fused_step_ref(fp, x, pos, cache_k, cache_v, kv_scales, dims=dims,
                              norm_eps=norm_eps)
    L, d, f = dims.n_layers, dims.dim, dims.hidden
    B = x.shape[0]
    if dims.head_dim != HEAD_DIM:
        raise ValueError(f"fused_decode_layers kernel takes head_dim {HEAD_DIM}, "
                         f"got {dims.head_dim}")
    if max(d, f) // (2 if dims.wbits == 4 else 1) > MAX_ROW_BYTES:
        raise ValueError(f"fused_decode_layers kernel takes weight rows of at most "
                         f"{MAX_ROW_BYTES} bytes")
    if not 1 <= B <= MAX_BATCH or max(d, f) * (4 + B) + 4 * B > GEMV_SMEM:
        raise ValueError(f"fused_decode_layers kernel takes 1..{MAX_BATCH} rows with "
                         f"max(d, hidden) x (4 + rows) + 4 x rows <= {GEMV_SMEM} bytes, "
                         f"got {B} rows")
    positions = positions_of(pos, B)
    if len(positions) != B or min(positions) < 0:
        raise ValueError(f"fused_decode_layers: need {B} positions >= 0, got {positions}")
    cache_k, cache_v, kv_scales = as_batched(cache_k, cache_v, kv_scales)
    w_pad = cache_k.shape[2]
    if w_pad < dims.window:
        raise ValueError(f"fused_decode_layers: cache of {w_pad} slots < window {dims.window}")
    _need(x, torch.bfloat16, (B, d), "x")
    _need(cache_k, torch.int8, (L, B, w_pad, d), "cache_k")
    _need(cache_v, torch.int8, (L, B, w_pad, d), "cache_v")
    _need(kv_scales, torch.float32, (L, B, 2, w_pad), "kv_scales")
    check_pack(fp, dims)
    cos, sin = rope_rows(positions, dims, x.device)
    cos, sin = cos.contiguous(), sin.contiguous()
    pos_t = ints_on_device(positions, x.device, torch.int32)
    h = torch.empty((B, d), dtype=torch.float32, device=x.device)
    k_new = torch.empty((L, B, d), dtype=torch.float32, device=x.device)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(B * (4 * d + 2 * f), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dims.wbits, B, L, d, f, dims.n_heads, dims.window, w_pad, norm_eps,
                 x.data_ptr(), pos_t.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 *(fp[k].data_ptr() for k in ("wqkv", "sqkv", "wo", "so", "w13", "s13",
                                              "w2", "s2", "attn_norms", "ffn_norms")),
                 cache_k.data_ptr(), cache_v.data_ptr(), kv_scales.data_ptr(),
                 h.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"decode_layer kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return h, k_new, v_new
