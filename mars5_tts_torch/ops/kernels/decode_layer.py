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
rows), far below the tensor cores' break-even, so they run ``__dp4a`` on
CUDA cores. A step is one cooperative launch of a persistent kernel, one
block an SM, its phases parted by grid barriers; each block owns a fixed
row range of every matrix (``persistent_plan``) and bulk-copies its slice
of the next phase but one into shared memory while it computes, so the
weight stream runs through the barriers. Attention is split over the grid
by slot chunks (``attention_split``). See the CUDA source for the phases.

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
from functools import lru_cache

import torch

from ..quant import div, int8_matmul, quantize_act, quantize_weight, quantize_weight_mse
from ..rope import apply_rope_halfsplit, rope_angles
from ...utils.device import ints_on_device
from . import build

SOURCES = build.LIBRARIES["decode_layer"]
HEAD_DIM = 64          # the attention kernel's head width
MAX_ROW_BYTES = 4096   # a weight row a warp holds in registers (16 B x 8 a lane)
MAX_BATCH = 8          # activation rows a step takes
MAX_DIM = 2048         # d: 8 columns a thread of a 256-thread block, rows of <= 2048 bytes
MAX_HIDDEN = 4096      # hidden: 16 a thread
SMEM_LIMIT = 232_448   # shared memory a block may use on an H100 (227 KB)
STATIC_SMEM = 4096     # the kernel's static shared memory, at most (reductions, q, k, v)
SLOT_TILE = 64         # attention chunks are whole multiples of 64 slots
PHASES = ("wqkv", "wo", "w13", "w2")    # the weight phases of a layer, in order

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


def _int4(w, mse: bool):
    """Per-row int4 (``levels=7``): scales from the clip search, or amax."""
    return quantize_weight_mse(w, levels=7) if mse else quantize_weight(w, levels=7)


def _q4(w, mse: bool = True):
    """(out, in) -> packed (out, in/2), scales (2, out): each half of the
    input axis quantized on its own (``_int4``)."""
    h = w.shape[-1] // 2
    qa, sa = _int4(w[:, :h], mse)
    qb, sb = _int4(w[:, h:], mse)
    return pack4(qa, qb), torch.stack([sa, sb])


def build_fused_pack(codeclm, dims: FusedDims, int4_mse: bool = True) -> dict:
    """Quantize the backbone of a port ``CodecLM`` into the K2 pack (see the
    module docstring); int8 tensors and f32 scales on the model's device.
    ``int4_mse`` (int4 only): per-row scales from the clip search
    (``quantize_weight_mse``), else amax scales (the JAX
    ``MARS5_INT4_MSE=0``)."""
    quant = (lambda w: _q4(w, int4_mse)) if dims.wbits == 4 else _q8
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
            q, s = _int4(w2, int4_mse)
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
        return (cache_k[:, None], cache_v[:, None],
                None if kv_scales is None else kv_scales[:, None])
    return cache_k, cache_v, kv_scales


# --------------------------------------------------------------- plain twin

def _sum(x):
    """f32 sum over the last axis, accumulated in f64 and rounded once: the
    same f32 value in any order, so the kernel's block reduction gives it too."""
    return x.double().sum(dim=-1, keepdim=True).float()


def _rms_norm(h, w, eps):
    return h * (1.0 / torch.sqrt(div(_sum(h * h), h.shape[-1]) + eps)) * w


def _rms_quant(h, w, eps):
    return quantize_act(_rms_norm(h, w, eps))


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


def _attention_plain(q, k_new, v, ck, cv, valid, dims: FusedDims):
    """``_attention`` over a float ring (W_pad, d): q rounded to bf16 against
    the cached keys and p rounded to bf16 against the cached values, f32 sums
    (the JAX structure oracle's attention)."""
    H, Dh = dims.n_heads, dims.head_dim
    scale = 1.0 / math.sqrt(Dh)
    qh, kh, vh = q.view(H, Dh), k_new.view(H, Dh), v.view(H, Dh)
    kc = ck.view(-1, H, Dh).float()
    scores = torch.einsum("hd,whd->hw", qh.bfloat16().float(), kc) * scale
    scores = scores.masked_fill(~valid[None, :], float("-inf"))
    self_s = _self_scores(qh, kh, scale)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), self_s)
    p = torch.exp(scores - m)
    p_self = torch.exp(self_s - m)
    denom = _sum(p) + p_self
    out = torch.einsum("hw,whd->hd", p.bfloat16().float(), cv.view(-1, H, Dh).float())
    return (out / denom + (p_self / denom) * vh).reshape(1, -1)


def _dot_plain(x, w, s):
    """x (B, K) f32 times a W8 pack matrix dequantized, ``q * s`` per row, in f32."""
    return x @ (w.float() * s.reshape(-1, 1)).t()


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
                   norm_eps: float = 1e-5, quantized: bool = True):
    """Plain version of K2 (the JAX package's ``fused_step_emulation_batched``,
    one ``fused_step_emulation`` with ``quantized=True`` a row).

    x (B, d) embedded tokens (bf16); pos an int or B ints; cache_k/cache_v
    (L, B, W_pad, d) int8 with W_pad >= window (slots past the window are
    ignored); kv_scales (L, B, 2, W_pad) f32 (row 0 K, row 1 V); one row may
    pass (L, W_pad, d) / (L, 2, W_pad). Returns (h (B, d) f32 before the
    final norm, k_new (L, B, d) f32 roped, v_new (L, B, d) f32).

    ``quantized=False`` is the structure oracle (``fused_step_emulation(
    quantized=False)``, W8 packs only): every product an f32 product with the
    dequantized weights, the caches float (bf16 or f32) and ``kv_scales``
    unused, so the pack's layout, the RoPE, the ring mask and the attention
    can be held to the unquantized decode step apart from int8 rounding."""
    w4 = dims.wbits == 4
    if not quantized:
        if w4:
            raise NotImplementedError("the structure (unquantized) oracle is wbits=8 only")
        return _step_plain(fp, x, pos, cache_k, cache_v, dims, norm_eps)
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


def _step_plain(fp, x, pos, cache_k, cache_v, dims: FusedDims, norm_eps: float):
    """``fused_step_ref(quantized=False)``."""
    B, d = x.shape[0], dims.dim
    cache_k, cache_v, _ = as_batched(cache_k, cache_v, None)
    positions = positions_of(pos, B)
    cos, sin = rope_rows(positions, dims, x.device)
    cos, sin = cos[:, None], sin[:, None]
    valid = [_ring_valid(p, dims.window, cache_k.shape[2], x.device) for p in positions]
    h = x.float().reshape(B, d)
    k_news, v_news = [], []
    heads = (B, dims.n_heads, dims.head_dim)
    for l in range(dims.n_layers):
        qkv = _dot_plain(_rms_norm(h, fp["attn_norms"][l], norm_eps), fp["wqkv"][l],
                         fp["sqkv"][l])
        q = apply_rope_halfsplit(qkv[:, :d].reshape(heads), cos, sin).reshape(B, d)
        k = apply_rope_halfsplit(qkv[:, d:2 * d].reshape(heads), cos, sin).reshape(B, d)
        v = qkv[:, 2 * d:]
        k_news.append(k)
        v_news.append(v)
        attn = torch.cat([_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], cache_k[l, b],
                                           cache_v[l, b], valid[b], dims) for b in range(B)])
        h = h + _dot_plain(attn, fp["wo"][l], fp["so"][l])
        ab = _dot_plain(_rms_norm(h, fp["ffn_norms"][l], norm_eps), fp["w13"][l],
                        fp["s13"][l])
        a, b_ = ab[:, :dims.hidden], ab[:, dims.hidden:]
        h = h + _dot_plain(a * (1.0 / (1.0 + torch.exp(-a))) * b_, fp["w2"][l], fp["s2"][l])
    return h, torch.stack(k_news), torch.stack(v_news)


# ------------------------------------------------------------- the plan

@dataclass(frozen=True)
class PersistentPlan:
    """The launch of one K2 step, fixed by the host and taken as given by the
    kernel: ``grid`` blocks; ``rows[k]`` the ``grid + 1`` row boundaries of
    phase ``PHASES[k]`` (block i owns rows ``rows[k][i]:rows[k][i + 1]``; for
    w13 the rows of w1 and the same rows of w3, so one block holds both halves
    of its u columns); ``slice_bytes[k]`` the largest slice a block loads in
    phase k; dynamic shared memory: weight buffer A (wqkv, w13) at 0, the
    RMSNorm weight the A phases copy in with their slices at ``off_norm``,
    buffer B (wo, w2) at ``off_b``, the activation rows as f32 at ``off_act``, a
    vector at ``off_vec`` (the attention's per-head values, then the wo and w2
    results before they are added to h: d floats, or more for a small grid), the activation rows as int8 at ``off_x8``,
    ``smem_bytes`` in all."""

    grid: int
    rows: tuple
    slice_bytes: tuple
    off_norm: int
    off_b: int
    off_act: int
    off_vec: int
    off_x8: int
    smem_bytes: int

    def phase_rows(self, k: int, block: int) -> tuple[int, int]:
        return self.rows[k][block], self.rows[k][block + 1]


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def row_bytes(dims: FusedDims) -> tuple[int, ...]:
    """Bytes of one weight row of each phase (wqkv, wo, w13, w2)."""
    div = 2 if dims.wbits == 4 else 1
    return (dims.dim // div,) * 3 + (dims.hidden // div,)


def phase_rows(dims: FusedDims) -> tuple[int, ...]:
    """Rows each phase splits over the grid: w13 by its u columns (pairs)."""
    return 3 * dims.dim, dims.dim, dims.hidden, dims.dim


def persistent_plan(dims: FusedDims, batch: int, sm_count: int,
                    blocks_per_sm: int = 1) -> PersistentPlan:
    """The row ranges, shared memory and grid of a K2 step of ``batch`` rows
    on ``sm_count`` SMs with ``blocks_per_sm`` blocks each. Block i owns rows
    ``i * N // grid`` up to ``(i + 1) * N // grid`` of a phase of N rows; each
    slice is whole rows, so 16-byte aligned when a row is a multiple of 16
    bytes. Phases alternate between two buffers, so any two consecutive
    phases are in shared memory at once. Raises when a row is not a multiple
    of 16 bytes or longer than ``MAX_ROW_BYTES``, or when the buffers and the
    activation rows exceed a block's shared memory."""
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"K2 takes 1..{MAX_BATCH} rows, got {batch}")
    if sm_count < 1 or blocks_per_sm < 1:
        raise ValueError("K2 needs at least one block")
    grid = sm_count * blocks_per_sm
    rb = row_bytes(dims)
    if (any(r % 16 or r > MAX_ROW_BYTES for r in rb) or dims.dim > MAX_DIM
            or dims.hidden > MAX_HIDDEN):
        raise ValueError(f"K2 takes weight rows of a multiple of 16 bytes up to "
                         f"{MAX_ROW_BYTES}, dim up to {MAX_DIM} and hidden up to {MAX_HIDDEN}, "
                         f"got rows {rb}, dim {dims.dim}, hidden {dims.hidden}")
    rows = tuple(tuple(i * n // grid for i in range(grid + 1)) for n in phase_rows(dims))
    per = (1, 1, 2, 1)                 # w13: a w1 row and a w3 row per u column
    slices = tuple(max(r[i + 1] - r[i] for i in range(grid)) * b * m
                   for r, b, m in zip(rows, rb, per))
    off_norm = _up16(max(slices[0], slices[2]))
    off_b = off_norm + _up16(4 * dims.dim)
    off_act = off_b + _up16(max(slices[1], slices[3]))
    off_vec = off_act + _up16(4 * batch * dims.dim)
    most = max(r[i + 1] - r[i] for r in (rows[1], rows[3]) for i in range(grid))
    off_x8 = off_vec + _up16(4 * max(dims.dim, batch * most))
    smem = off_x8 + _up16(batch * max(dims.dim, dims.hidden))
    if smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"K2 at {batch} rows on a grid of {grid} needs {smem} bytes of "
                         f"shared memory a block, over {SMEM_LIMIT - STATIC_SMEM}")
    return PersistentPlan(grid, rows, slices, off_norm, off_b, off_act, off_vec, off_x8, smem)


def attention_split(grid: int, batch: int, n_heads: int, slots: int) -> tuple[int, int]:
    """(chunk, n_chunks): each (row, head)'s first ``slots`` ring slots (the
    most any row has valid) in chunks of ``chunk`` slots, a multiple of
    ``SLOT_TILE``, so that the ``batch * n_heads * n_chunks`` units about
    fill the grid. One chunk runs the whole attention of a (row, head) in
    one block, with no grid barrier inside it."""
    per = min(32, max(1, grid // (batch * n_heads)))     # chunks a (row, head)
    per_chunk = -(-slots // per)
    chunk = max(SLOT_TILE, -(-per_chunk // SLOT_TILE) * SLOT_TILE)
    return chunk, -(-slots // chunk)


SCRATCH_REGIONS = ("qkv", "u", "uamax", "scores", "pmax", "pamax", "selfs", "stats", "pv",
                   "psum")                       # the kernel's order


def scratch_layout(dims: FusedDims, batch: int, w_pad: int, grid: int,
                   n_chunks: int) -> dict:
    """Byte offsets of the step's scratch regions in the kernel's order, and
    ``"bytes"`` in all: qkv (B, 3d) f32, u (B, hidden) f32, the u amax of
    each block (grid, B) f32, scores (B, H, w_pad) f32, per chunk the score
    max and the amax of p * vs (B, H, n_chunks) f32 each, the self scores
    (B, H) f32, the PV sums (B, d) int32, and the denominator's f64 sum over
    each ``SLOT_TILE`` slots (B, H, ceil(window / SLOT_TILE)): summed tile by
    tile in slot order, the total does not depend on the chunks."""
    bh = batch * dims.n_heads
    tiles = -(-dims.window // SLOT_TILE)
    sizes = {"qkv": 4 * batch * 3 * dims.dim, "u": 4 * batch * dims.hidden,
             "uamax": 4 * grid * batch, "scores": 4 * bh * w_pad, "pmax": 4 * bh * n_chunks,
             "pamax": 4 * bh * n_chunks, "selfs": 4 * bh, "stats": 12 * bh,
             "pv": 4 * batch * dims.dim, "psum": 8 * bh * tiles}
    out, at = {}, 0
    for name in SCRATCH_REGIONS:
        out[name] = at
        at += _up16(sizes[name])
    out["bytes"] = at
    return out


# ------------------------------------------------------------------- kernel

def _lib():
    lib = build.load("decode_layer", SOURCES)
    fn = lib.mars5_fused_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # wbits, B, L, d, hidden, n_heads, window, w_pad, eps, grid, rows, off_b,
        # off_norm, off_act, off_vec, off_x8, smem, chunk, n_chunks, x, pos, cos, sin, wqkv,
        # sqkv, wo,
        # so, w13, s13, w2, s2, attn_norms, ffn_norms, cache_k, cache_v,
        # kv_scales, h, k_new, v_new, scratch, offsets (host, 10 x int64),
        # scratch_bytes, barrier, stream
        fn.argtypes = ([i] * 8 + [ctypes.c_float, i, vp] + [i] * 8 + [vp] * 22
                       + [ctypes.c_longlong, vp, vp])
        fn.restype = ctypes.c_int
        occ = lib.mars5_fused_decode_occupancy
        occ.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        lib.mars5_fused_decode_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_launches() -> int:
    """CUDA kernels the K2 library has launched in this process (one a step),
    counted by its C entry; ``launch_count`` counts the wrapper's calls."""
    return _lib().mars5_fused_decode_kernel_launches()


@lru_cache(maxsize=None)
def _launch_plan(dims: FusedDims, batch: int, device_index: int):
    """The plan of a step on this device (one block an SM: each block runs
    the activation prologue of every phase, so more blocks would repeat it
    and add arrivals at every barrier), its row table on the device and the
    grid barrier's counter, zeroed once (the kernel leaves it as it found
    it). Raises unless one block of the plan's shared memory fits an SM."""
    sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    plan = persistent_plan(dims, batch, sm, 1)
    per_sm = ctypes.c_int(0)
    err = _lib().mars5_fused_decode_occupancy(plan.smem_bytes, ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"fused_decode_layers: a block of {plan.smem_bytes} bytes of "
                           f"shared memory cannot reside on an SM (cudaError {err})")
    dev = torch.device("cuda", device_index)
    rows = torch.tensor(plan.rows, dtype=torch.int32, device=dev).contiguous()
    barrier = torch.zeros(64, dtype=torch.int32, device=dev)   # count, finish count at 32
    return plan, rows, barrier


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
    positions >= 0, head_dim 64, weight rows of a multiple of 16 bytes up to
    4096, a plan that fits shared memory (``persistent_plan``), a pack as
    ``build_fused_pack`` makes it. The step is one cooperative launch: if
    its grid cannot be resident at once, the launch fails and this raises."""
    if x.device.type == "cpu":
        return fused_step_ref(fp, x, pos, cache_k, cache_v, kv_scales, dims=dims,
                              norm_eps=norm_eps)
    L, d, f = dims.n_layers, dims.dim, dims.hidden
    B = x.shape[0]
    if dims.head_dim != HEAD_DIM:
        raise ValueError(f"fused_decode_layers kernel takes head_dim {HEAD_DIM}, "
                         f"got {dims.head_dim}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"fused_decode_layers kernel takes 1..{MAX_BATCH} rows, got {B}")
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
    pos_t = ints_on_device(positions, x.device, torch.int32)
    cos, sin = rope_angles(pos_t, dims.head_dim)     # rope_rows in one pass
    dev_index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan, rows, barrier = _launch_plan(dims, B, dev_index)
    slots = max(min(p + 1, dims.window) for p in positions)
    chunk, n_chunks = attention_split(plan.grid, B, dims.n_heads, slots)
    layout = scratch_layout(dims, B, w_pad, plan.grid, n_chunks)
    offsets = (ctypes.c_longlong * len(SCRATCH_REGIONS))(*(layout[k] for k in SCRATCH_REGIONS))
    h = torch.empty((B, d), dtype=torch.float32, device=x.device)
    k_new = torch.empty((L, B, d), dtype=torch.float32, device=x.device)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(layout["bytes"], dtype=torch.uint8, device=x.device)
    fn = _lib().mars5_fused_decode
    build.call(x.device, fn, dims.wbits, B, L, d, f, dims.n_heads, dims.window, w_pad,
               norm_eps, plan.grid, rows.data_ptr(), plan.off_norm, plan.off_b, plan.off_act,
               plan.off_vec, plan.off_x8, plan.smem_bytes, chunk, n_chunks, x.data_ptr(), pos_t.data_ptr(),
               cos.data_ptr(), sin.data_ptr(),
               *(fp[k].data_ptr() for k in ("wqkv", "sqkv", "wo", "so", "w13", "s13",
                                            "w2", "s2", "attn_norms", "ffn_norms")),
               cache_k.data_ptr(), cache_v.data_ptr(), kv_scales.data_ptr(),
               h.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
               ctypes.addressof(offsets), layout["bytes"], barrier.data_ptr())
    global launch_count
    launch_count += 1
    return h, k_new, v_new
