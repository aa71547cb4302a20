"""Bidirectional attention kernel K1 (``csrc/mha.cu``) and its plain twin.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel``
(entry ``sdpa_pallas`` with ``quantized=False``): the NAR decoder's
self-attention and the speaker encoders' self-attention at 512 frames and up.

What bounds it on an H100: at the NAR shape (2, 1200, 16, 64) one call moves
about 20 MB (q, k, v and the output, bf16) and does
2*2*2*1200^2*16*64 ~ 11.8 GFLOP, about 600 FLOP per byte, so it is bound by
the tensor cores, which only wgmma drives at their rate. The TPU kernel held
a whole row of keys in VMEM; a Hopper CTA cannot, so the bf16 kernel gives
each CTA 192 queries of one head (three consumer warpgroups) and streams
128-key K/V tiles through a two-stage shared-memory ring, loaded by TMA from
4-D tensor maps over the caller's views while the consumers run both
products on wgmma with an online softmax; the score matrix never reaches
device memory. The f32 kernel (off the default path) runs on CUDA cores.

``mha`` takes ``mha_ref`` only for CPU tensors. For CUDA tensors it launches
the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

LOG2E = 1.4426950408889634
HEAD_DIM = 64
SOURCES = build.LIBRARIES["mha"]

# Launches of the CUDA kernel in this process (reset with reset_launch_count).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def mha_ref(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of the kernel's math.

    q (B, Lq, H, D), k/v (B, Lk, H, D); key_padding_mask (B, Lk) bool,
    True = ignore. f32 scores, -inf on masked keys, max-subtracted exp2 with
    the 1/sqrt(D) scale folded in, PV on probabilities rounded to the input
    dtype with f32 accumulation, and division by the f32 row sum last.
    Unlike ``ops.attention.sdpa`` it never rounds the scores to bf16.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * (scale * LOG2E))
    r = p.sum(dim=-1, keepdim=True)                       # (B, H, Lq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return (o / r.permute(0, 2, 1, 3)).to(q.dtype)


def bf16_row_bound(ref):
    """Stated tolerance between K1 and ``mha_ref`` (or the Pallas kernel) in
    bf16: 2 bf16 ulp of each output row's largest |entry|, per element. The
    kernel rounds p to bf16 at a running row max, the twins at the final max."""
    peak = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    return 2.0 * torch.exp2(torch.floor(torch.log2(peak)) - 7)


def _lib():
    lib = build.load("mha", SOURCES)
    fn = lib.mars5_mha_fwd
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def tensor_map_encode_us(q, k, v, reps: int = 1000) -> float:
    """Host microseconds the bf16 kernel's entry spends encoding one call's
    three tensor maps, averaged over ``reps`` encodes (bf16 views on the
    card, as ``mha`` takes them)."""
    fn = build.load("mha", SOURCES).mars5_mha_encode_us
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, i, i, i, i] + [ll] * 9 + [i]
    fn.restype = ctypes.c_double
    b, lq, lk, h, _, *strides = launch_args(q, k, v)
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, lq, lk, h, *strides, reps)
    if us < 0:
        raise RuntimeError("mha: encoding the tensor maps failed")
    return us


def tensor_map_strides(x):
    """The element strides (batch, sequence, head) under which the kernel
    reads ``x`` (B, L, H, 64) in place: TMA's tensor maps take a unit stride
    on the head dim, every other stride a multiple of 16 bytes and a 16-byte
    aligned base; the f32 kernel's 16-byte loads take the same. A size-1
    axis is never stepped, so its stride is replaced by a qualifying one.
    Raises ValueError naming what a view breaks (``.contiguous()`` always
    qualifies)."""
    shape, st = x.shape, x.stride()
    if len(shape) != 4 or shape[3] != HEAD_DIM:
        raise ValueError(f"mha: expected (B, L, H, {HEAD_DIM}), got {tuple(shape)}")
    if st[3] != 1:
        raise ValueError(f"mha: the head dim must have unit stride, got strides {st}")
    (b, l, h), (sb, sl, sh) = shape[:3], st[:3]
    span = max(b * sb if b > 1 else 0, l * sl if l > 1 else 0, h * sh if h > 1 else 0,
               HEAD_DIM)
    sb, sl, sh = (sb if b > 1 else span), (sl if l > 1 else span), (sh if h > 1 else span)
    per16 = 16 // x.element_size()
    if sb % per16 or sl % per16 or sh % per16:
        raise ValueError(f"mha: strides {st} are not multiples of 16 bytes")
    if x.data_ptr() % 16:
        raise ValueError("mha: the view does not start on a 16-byte boundary")
    return sb, sl, sh


def launch_args(q, k, v, key_padding_mask=None):
    """The kernel's arguments after the pointers: (B, Lq, Lk, H, D, the three
    views' strides); raises ValueError on anything the kernel does not take
    (head dim, dtype, shapes, devices, mask, views)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dt = q.dtype
    if d != HEAD_DIM:
        raise ValueError(f"mha kernel supports head_dim {HEAD_DIM}, got {d}")
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise ValueError(f"mha kernel takes bf16 or f32, got {dt}")
    if k.dtype is not dt or v.dtype is not dt:
        raise ValueError("mha: q, k and v must share a dtype")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"mha: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("mha: q, k and v must be on one device")
    if key_padding_mask is not None and (key_padding_mask.dtype is not torch.bool
                                         or key_padding_mask.shape != (b, lk)):
        raise ValueError("mha: key_padding_mask must be bool (B, Lk)")
    return (b, lq, lk, h, d, *tensor_map_strides(q), *tensor_map_strides(k),
            *tensor_map_strides(v))


def mha(q, k, v, key_padding_mask=None):
    """Attention of q (B, Lq, H, D) over k/v (B, Lk, H, D) -> (B, Lq, H, D).

    CPU tensors take ``mha_ref``; CUDA tensors launch the kernel (bf16 or
    f32, D = 64, views as ``tensor_map_strides`` takes them) and raise on
    anything it does not take (``launch_args``).
    """
    if q.device.type == "cpu":
        return mha_ref(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    args = launch_args(q, k, v, key_padding_mask)
    mask_ptr = None
    if key_padding_mask is not None:
        key_padding_mask = key_padding_mask.to(q.device).contiguous()
        mask_ptr = key_padding_mask.data_ptr()
    b, lq, _, h, d = args[:5]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    build.call(q.device, _lib(), int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
               v.data_ptr(), mask_ptr, out.data_ptr(), *args, 1.0 / math.sqrt(d))
    global launch_count
    launch_count += 1
    return out
