"""One decode token's attention over the ring KV cache, kernel K7
``decode_attention`` (``csrc/decode_attention.cu``), and its plain twin.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/decode_attention.py::
_make_kernel`` (entry ``decode_attention_pallas``), the function the JAX
engines compute with XLA (``models/ar_decode._decode_attention``): for each
row b at position ``pos[b]``, ring slot s holds position
``pos - ((pos - s) mod W)``; slots whose position is negative (never
written, or prompt padding ahead of the cursor) are masked. With
``k_new``/``v_new`` (the self-column mode the bf16 AR engine uses) the cache
does not hold the current token yet: its stale slot ``pos mod W`` is masked
too and the token attends to itself through one extra column. Scores are
f32, scaled by 1/sqrt(D); the softmax runs over the valid slots and the self
column; the ring's probabilities are rounded to the cache dtype before the
PV product, the self column's stay f32.

What bounds it on an H100: bytes. At the released widths (24 heads of 64, a
2,001-slot bf16 ring) one layer's K and V of one row are 12.3 MB when every
slot is valid, against ~3 MFLOP; the kernel reads only the valid slots
(``min(pos + 1, W)`` of them) and skips the V rows whose probability is 0.
Each (head, row) is split over a thread-block cluster of ``cluster_size``
CTAs, which exchange the max, the f64 exp sum and the f64 PV partials
through distributed shared memory, so every CTA rounds the probabilities
with the row's global max and denominator, as the twin does. The AR runs it
once a layer, 26 times a token.

Numerics: the q . k dots, the softmax denominator and the PV sums accumulate
in f64 and round to f32 once, in kernel and twin alike (the products of f32
or bf16 values are exact in f64), so the two agree bit for bit except where
two f64 sums taken in other orders fall on either side of an f32 rounding
boundary.

``decode_attention`` takes the twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

SOURCES = build.LIBRARIES["decode_attention"]
HEAD_DIM = 64          # the kernel's head width
MAX_WINDOW = 8192      # the ring slots whose scores a cluster keeps in shared memory
SLOTS_PER_CTA = 256    # valid slots a CTA of the cluster is sized for
MAX_CLUSTER = 8        # the portable cluster size
CTA_BUDGET = 300       # CTAs a call aims at: about two on each of an H100's 132 SMs

# Launches of the CUDA kernel in this process (reset with reset_launch_count).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _positions(pos, b: int, device):
    """``pos`` (an int, a sequence of ints or a tensor) as a (B,) tensor on
    ``device``."""
    p = torch.as_tensor(pos, device=device)
    return p.reshape(-1).expand(b) if p.numel() == 1 else p.reshape(b)


def cluster_size(n_slots: int, pairs: int = 1) -> int:
    """The CTAs a (head, row) takes for at most ``n_slots`` valid ring slots
    and ``pairs`` (head, row) pairs: one per ``SLOTS_PER_CTA`` slots, 1 to
    ``MAX_CLUSTER``, and no more than keeps the call near ``CTA_BUDGET`` CTAs
    (more CTAs than the card holds at once cost more than they split)."""
    return max(1, min(MAX_CLUSTER, -(-n_slots // SLOTS_PER_CTA), CTA_BUDGET // pairs))


def slot_bound(pos, window: int, max_pos=None) -> int:
    """The host's bound on a row's valid slots: from ``max_pos`` when given,
    else from host positions (an int or a sequence); a device tensor of
    positions gives the whole window (reading it would wait for the card)."""
    if max_pos is None and not isinstance(pos, torch.Tensor):
        max_pos = max(np.asarray(pos).reshape(-1).tolist())
    return window if max_pos is None else min(int(max_pos) + 1, window)


def ring_valid(pos, window: int, self_column: bool):
    """(B, W) bool: the ring slots a row at ``pos`` (B,) attends."""
    slots = torch.arange(window, device=pos.device)
    p = pos.long()[:, None]
    valid = p - torch.remainder(p - slots, window) >= 0
    if self_column:
        valid &= slots[None] != torch.remainder(p, window)
    return valid


def _sum(x):
    """f32 sum over the last axis, accumulated in f64 and rounded once."""
    return x.double().sum(dim=-1, keepdim=True).float()


def decode_attention_ref(q, ck, cv, pos, k_new=None, v_new=None):
    """Plain version of K7. q (B, H, D); ck/cv (B, W, H, D), one layer's
    view of the ring; pos (B,) positions (>= 0); k_new/v_new (B, H, D) or
    None. Returns (B, H, D) in q's dtype."""
    b, w = ck.shape[:2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    pos = _positions(pos, b, q.device)
    self_column = k_new is not None
    s = torch.einsum("bhd,bwhd->bhw", q.double(), ck.double()).float() * scale
    s = s.masked_fill(~ring_valid(pos, w, self_column)[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if self_column:
        self_s = _sum(q.double() * k_new.double()) * scale           # (B, H, 1)
        m = torch.maximum(m, self_s)
        p_self = torch.exp(self_s - m)
    p = torch.exp(s - m)
    denom = _sum(torch.cat([p, p_self], dim=-1) if self_column else p)
    probs = (p / denom).to(q.dtype)
    out = torch.einsum("bhw,bwhd->bhd", probs.double(), cv.double()).float()
    if self_column:
        out = out + (p_self / denom) * v_new.float()
    return out.to(q.dtype)


def one_ulp(got, want):
    """The stated tolerance between K7 and its twin, per element: one ulp of
    the output dtype at the larger magnitude of the two (an f64 sum that
    lands on the other side of an f32 rounding boundary moves the f32 value
    by one ulp, and so the bf16 output by at most one)."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    a = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(2.0 ** -120)
    return torch.exp2(torch.floor(torch.log2(a)) - mant)


def _lib():
    lib = build.load("decode_attention", SOURCES)
    fn = lib.mars5_decode_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # bf16, q, ck, cv, k_new, v_new, pos, out, B, W, H, D, cluster, scale, stream
        fn.argtypes = [i] + [vp] * 7 + [i] * 5 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def launch_args(q, ck, cv, pos, k_new=None, v_new=None, max_pos=None):
    """(B, W, H, D, cluster size) for the kernel; raises ValueError on what it
    does not take: bf16 or f32 throughout, head dim 64, 1..8,192 slots,
    contiguous 16-byte aligned rings, both or neither of k_new and v_new."""
    b, h, d = q.shape
    w = ck.shape[1]
    dt, dev = q.dtype, q.device
    if d != HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head_dim {HEAD_DIM}, got {d}")
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise ValueError(f"decode_attention kernel takes bf16 or f32, got {dt}")
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"decode_attention kernel takes 1..{MAX_WINDOW} slots, got {w}")
    if (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: give both k_new and v_new, or neither")
    ring, new = (b, w, h, d), (b, h, d)
    for t, shape in ((ck, ring), (cv, ring)) if k_new is None else (
            (ck, ring), (cv, ring), (k_new, new), (v_new, new)):
        if t.dtype is not dt or t.shape != shape or t.device != dev:
            raise ValueError(f"decode_attention: expected {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (ck.is_contiguous() and cv.is_contiguous()) or (ck.data_ptr() | cv.data_ptr()) % 16:
        raise ValueError("decode_attention: the rings must be contiguous and 16-byte aligned")
    return b, w, h, d, cluster_size(slot_bound(pos, w, max_pos), b * h)


def _device_positions(pos, b: int, device):
    """The (B,) int32 contiguous positions on ``device`` the kernel reads;
    such a tensor is taken as it is."""
    if (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and pos.device == device
            and pos.shape == (b,) and pos.is_contiguous()):
        return pos
    return _positions(pos, b, device).to(torch.int32).contiguous()


def decode_attention(q, ck, cv, pos, k_new=None, v_new=None, max_pos=None):
    """K7: one token's attention over the ring; arguments as
    ``decode_attention_ref``. ``max_pos``: a host bound on the rows'
    positions, which sizes the cluster (any bound gives the same result;
    without it, host ``pos`` gives it, a device tensor the whole window).

    CPU tensors take ``decode_attention_ref``. CUDA tensors launch the
    kernel and raise on what it does not take (``launch_args``)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, pos, k_new, v_new)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, w, h, d, cluster = launch_args(q, ck, cv, pos, k_new, v_new, max_pos)
    pos_t = _device_positions(pos, b, q.device)
    q = q.contiguous()
    kn = vn = None
    if k_new is not None:
        kn, vn = k_new.contiguous().data_ptr(), v_new.contiguous().data_ptr()
    out = torch.empty_like(q)
    build.call(q.device, _lib(), int(q.dtype == torch.bfloat16), q.data_ptr(), ck.data_ptr(),
               cv.data_ptr(), kn, vn, pos_t.data_ptr(), out.data_ptr(), b, w, h, d, cluster,
               1.0 / math.sqrt(d))
    global launch_count
    launch_count += 1
    return out
