"""Bidirectional attention kernel K1 (``csrc/mha.cu``) and its plain twin.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel``
(entry ``sdpa_pallas`` with ``quantized=False``): the NAR decoder's
self-attention and the speaker encoders' self-attention at 512 frames and up.

What bounds it on an H100: at the NAR shape (2, 1200, 16, 64) one call moves
about 20 MB (q, k, v and the output, bf16) and does
2*2*2*1200^2*16*64 ~ 11.8 GFLOP, about 600 FLOP per byte, so it is bound by
compute, not memory. The TPU kernel held a whole row of keys in VMEM; a Hopper
block cannot, so the kernel gives each block 64 queries of one head, walks the
keys in 64-wide shared-memory tiles with an online softmax and keeps the
output tile in f32 registers until one final normalization; the score matrix
never reaches device memory. This first version uses ``mma.sync`` (bf16) or
CUDA-core FMAs (f32) with no wgmma or TMA: a CUDA-core version would be bound
by FMA throughput at ~0.2 ms a call at best, and the NAR makes 3,200 calls per
utterance, which is why later work moves it to wgmma.

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


def _kernel_view(x):
    """x itself when the kernel can read it in place (unit stride on D, 16-byte
    aligned rows), else a contiguous copy."""
    per16 = 16 // x.element_size()
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:3]))
    return x if ok else x.contiguous()


def mha(q, k, v, key_padding_mask=None):
    """Attention of q (B, Lq, H, D) over k/v (B, Lk, H, D) -> (B, Lq, H, D).

    CPU tensors take ``mha_ref``; CUDA tensors launch the kernel (bf16 or
    f32, D = 64) and raise on anything it does not take.
    """
    if q.device.type == "cpu":
        return mha_ref(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f"mha kernel supports head_dim {HEAD_DIM}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mha kernel takes bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("mha: q, k and v must share a dtype")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"mha: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("mha: q, k and v must be on one device")
    mask_ptr = None
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool or key_padding_mask.shape != (b, lk):
            raise ValueError("mha: key_padding_mask must be bool (B, Lk)")
        key_padding_mask = key_padding_mask.to(q.device).contiguous()
        mask_ptr = key_padding_mask.data_ptr()
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), mask_ptr, out.data_ptr(), b, lq, lk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"mha kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out
