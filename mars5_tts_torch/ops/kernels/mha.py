"""Bidirectional attention kernel K1 (``csrc/mha.cu``) and its plain twin.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel``
(entry ``sdpa_pallas``): the NAR decoder's self-attention, the speaker
encoders' self-attention at 512 frames and up and, where asked
(``ops.attention.torch_mha(cross_k1=True)``), long-query cross-attention;
``quantized=True`` is its int8 QK / PV mode (``qattn``), which the W8A8
NAR's unfused layers run.

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
The int8 mode (bf16 only) is three launches (``int8_plan``): a pre-pass that
quantizes k per row and takes v's per-channel maxima by key blocks, one
that quantizes v per channel into a transposed buffer, then the attention
kernel: the bf16 kernel's CTA shape with q quantized inside it, a TMA-fed
ring of int8 K / V tiles walked twice (the row max, then p, its sum and
PV), both products on wgmma s8 (``csrc/mha.cu``).

``mha`` takes ``mha_ref`` only for CPU tensors. For CUDA tensors it launches
the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..quant import div, quantize_act
from . import build

LOG2E = 1.4426950408889634
HEAD_DIM = 64
SOURCES = build.LIBRARIES["mha"]

# The int8 mode's geometry (csrc/mha.cu): queries a CTA, keys a ring tile,
# keys a pre-pass block, keys a v8_key block (v8t's rows are padded to it).
INT8_QUERIES, INT8_KEYS, INT8_PRE_KEYS, V8_BLOCK = 192, 128, 64, 32

# Calls of the wrapper on CUDA tensors in this process, all modes, and of
# those the int8 mode's (reset with reset_launch_count); the kernels they
# launched are kernel_launches().
launch_count = 0
int8_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, int8_launch_count
    launch_count = int8_launch_count = 0


def _mha_int8_ref(q, k, v, key_padding_mask, stats: bool = False):
    """The int8 mode of ``mha_ref`` (JAX ``_mha_kernel(quantized=True)``);
    ``stats`` also returns v's channel scales vs (B, 1, H, D), the row sums
    r (B, Lq, H, 1) and the integer PV sums p8 . v8 (B, Lq, H, D), f64."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q8, qs = quantize_act(q.float())                      # (B, L, H, D), (B, L, H, 1)
    k8, ks = quantize_act(k.float())
    # integer products in f64: exact (|sums| < 2^53), rounded once to f32 as
    # the int32 -> f32 conversion does
    si = torch.einsum("bqhd,bkhd->bhqk", q8.double(), k8.double()).float()
    s = (si * (qs * scale).permute(0, 2, 1, 3)) * ks.permute(0, 2, 3, 1)
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * LOG2E)
    r = p.sum(dim=-1, keepdim=True)                       # (B, H, Lq, 1)
    vf = v.float()
    vs = div(vf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8), 127.0)   # (B, 1, H, D)
    v8 = torch.round(vf / vs).clamp(-127, 127)
    p8 = torch.round(p * 127.0)
    pv = torch.einsum("bhqk,bkhd->bqhd", p8.double(), v8.double())
    o = pv.float() * div(vs, 127.0)
    r = r.permute(0, 2, 1, 3)
    out = (o / r).to(q.dtype)
    return (out, vs, r, pv) if stats else out


def mha_ref(q, k, v, key_padding_mask=None, quantized: bool = False):
    """Plain PyTorch version of the kernel's math.

    q (B, Lq, H, D), k/v (B, Lk, H, D); key_padding_mask (B, Lk) bool,
    True = ignore. f32 scores, -inf on masked keys, max-subtracted exp2 with
    the 1/sqrt(D) scale folded in, PV on probabilities rounded to the input
    dtype with f32 accumulation, and division by the f32 row sum last.
    Unlike ``ops.attention.sdpa`` it never rounds the scores to bf16.

    ``quantized``: the int8 mode. q and k int8 per row, s = (float(q8 .
    k8) * (qs * scale)) * ks; p = exp2((s - max) * log2e) against the full
    row's max; v int8 per channel over all Lk keys (masked ones included);
    o = float(rint(p * 127) . v8) * (vs / 127), then / sum(p).
    """
    if quantized:
        return _mha_int8_ref(q, k, v, key_padding_mask)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * (scale * LOG2E))
    r = p.sum(dim=-1, keepdim=True)                       # (B, H, Lq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return (o / r.permute(0, 2, 1, 3)).to(q.dtype)


def int8_bound(q, k, v, key_padding_mask=None, flips: int = 2):
    """(the twin's int8-mode output, the stated tolerance of the kernel
    against it per element). A step of one p8 (p * 127 within an ulp of a
    half, should the kernel's exp2 round differently from the twin's) moves
    an output by |v8| vs / 127 / r <= vs / r (|v8| <= 127): the tolerance is
    ``flips`` such steps plus 1 bf16 ulp of the output (the kernel's f32 row
    sum, taken in another order, may round o / r across a bf16 boundary)."""
    ref, vs, r, _ = _mha_int8_ref(q, k, v, key_padding_mask, stats=True)
    peak = ref.float().abs().clamp_min(2.0 ** -100)
    return ref, flips * vs / r + torch.exp2(torch.floor(torch.log2(peak)) - 7)


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


def int8_launch_args(q, k, v, key_padding_mask=None):
    """``launch_args`` of the int8 mode, which takes bf16 only: q is read
    through the bf16 kernel's tensor map, k and v by the pre-pass."""
    args = launch_args(q, k, v, key_padding_mask)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"mha: the int8 mode takes bf16, got {q.dtype}")
    return args


@dataclass(frozen=True)
class Int8Plan:
    """The int8 mode's launches and scratch at one (B, Lq, Lk, H).

    ``grids``: (x, y) of the three launches in order, the k pre-pass (64-key
    blocks, B H), the v pre-pass (the same over Lkp) and the attention (B H,
    192-query tiles, the ragged last tile launched last). ``parts``: name ->
    (byte offset, shape, dtype) in one int8 scratch of ``scratch_bytes``,
    each part on a 128-byte boundary. ``maps``: the TMA tensor maps over
    the scratch, name -> (dims, byte strides of dims 1 and 2, box, swizzle
    bytes), innermost first: k8 (B H, Lk, 64) read as 128-key x 64-byte
    boxes, v8t (B H, 64, Lkp) as 64-channel x 128-key boxes; both zero-fill
    past Lk (k8) or Lkp (v8t)."""
    lkp: int
    n_kb: int
    grids: tuple
    parts: dict
    scratch_bytes: int
    maps: dict


def int8_plan(b: int, lq: int, lk: int, h: int) -> Int8Plan:
    bh = b * h
    lkp = -(-lk // V8_BLOCK) * V8_BLOCK
    n_kb = -(-lk // INT8_PRE_KEYS)
    shapes = {"k8": ((bh, lk, HEAD_DIM), torch.int8), "v8t": ((bh, HEAD_DIM, lkp), torch.int8),
              "ks": ((bh, lk), torch.float32), "vs": ((bh, HEAD_DIM), torch.float32),
              "vmax": ((bh, n_kb, HEAD_DIM), torch.float32)}
    parts, off = {}, 0
    for name, (shape, dt) in shapes.items():
        parts[name] = (off, shape, dt)
        off += -(-math.prod(shape) * dt.itemsize // 128) * 128
    grids = ((n_kb, bh), (-(-lkp // INT8_PRE_KEYS), bh), (bh, -(-lq // INT8_QUERIES)))
    maps = {"k8": ((HEAD_DIM, lk, bh), (HEAD_DIM, lk * HEAD_DIM), (HEAD_DIM, INT8_KEYS, 1), 64),
            "v8t": ((lkp, HEAD_DIM, bh), (lkp, HEAD_DIM * lkp), (INT8_KEYS, HEAD_DIM, 1), 128)}
    return Int8Plan(lkp, n_kb, grids, parts, off, maps)


def _int8_lib():
    fn = build.load("mha", SOURCES).mars5_mha_int8_fwd
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # q, k, v, mask, out, k8, v8t, ks, vs, vmax, B, Lq, Lk, H, D, the
        # views' strides, Lkp, n_kb, scale, stream
        fn.argtypes = [vp] * 10 + [i] * 5 + [ll] * 9 + [i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def kernel_launches() -> int:
    """CUDA kernels the K1 library has launched in this process, counted by
    its C entries (one a call in bf16 and f32, three in the int8 mode)."""
    lib = build.load("mha", SOURCES)
    lib.mars5_mha_kernel_launches.restype = ctypes.c_longlong
    return lib.mars5_mha_kernel_launches()


def takes_twin(q) -> bool:
    """Whether ``mha`` computes on ``q`` with its plain twin: CPU tensors."""
    return q.device.type == "cpu"


def refuse_autograd(q, k, v) -> None:
    """Raise when autograd records and q, k or v needs a gradient: K1 has no
    backward, as the TPU kernel it ports has none (``jax.grad`` through
    ``sdpa_pallas`` fails to linearize), so the kernel route never cuts a
    gradient in silence."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "mha: kernel K1 has no backward (nor has the TPU kernel it ports); "
            "a CUDA attention with autograd recording must stay under "
            "ops.attention.KERNEL_SELF_ATTN_MIN_LEN queries, where it takes the "
            "plain attention, or run under torch.no_grad()")


def mha(q, k, v, key_padding_mask=None, quantized: bool = False):
    """Attention of q (B, Lq, H, D) over k/v (B, Lk, H, D) -> (B, Lq, H, D);
    ``quantized``: the int8 QK / PV mode (``mha_ref``).

    CPU tensors take ``mha_ref``; CUDA tensors launch the kernel (bf16 or
    f32, the int8 mode bf16 only; D = 64, views as ``tensor_map_strides``
    takes them) and raise on anything it does not take (``launch_args``,
    ``int8_launch_args``), and on inputs that need a gradient while
    autograd records: the kernel has no backward.
    """
    if takes_twin(q):
        return mha_ref(q, k, v, key_padding_mask, quantized)
    refuse_autograd(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    args = (int8_launch_args if quantized else launch_args)(q, k, v, key_padding_mask)
    mask_ptr = None
    if key_padding_mask is not None:
        key_padding_mask = key_padding_mask.to(q.device).contiguous()
        mask_ptr = key_padding_mask.data_ptr()
    b, lq, lk, h, d = args[:5]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    global launch_count, int8_launch_count
    if quantized:
        plan = int8_plan(b, lq, lk, h)
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.int8, device=q.device)
        base = scratch.data_ptr()
        build.call(q.device, _int8_lib(), q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                   out.data_ptr(),
                   *(base + plan.parts[n][0] for n in ("k8", "v8t", "ks", "vs", "vmax")),
                   *args, plan.lkp, plan.n_kb, 1.0 / math.sqrt(d))
        int8_launch_count += 1
    else:
        build.call(q.device, _lib(), int(q.dtype == torch.bfloat16), q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), *args,
                   1.0 / math.sqrt(d))
    launch_count += 1
    return out
