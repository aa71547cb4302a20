"""W4A8 output head of the quantized AR decode engine, kernel K8
``head4_logits`` (``csrc/head4.cu``), its plain twin and its pack.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/head4.py::_head4_kernel``
(entry ``head4_logits``): the AR's (n_vocab, dim) output projection read as
nibble-packed int4 (half the int8 head's bytes), with the same convention as
the K2 pack: the low nibble is input column c of the left half, the high
nibble column c + K/2, one int4 scale per output row and half (chosen by the
int4 clip search), per-row int8 activations. ``Mars5TTS(ar_backend="fused4",
head4=True)`` serves through it.

What bounds it on an H100: the weight stream, 18.4 MB a step at 24,000 x
1536, for up to 8 activation rows (the batched engine's rows share it). One
launch a call: a grid sized to the SMs, each block a contiguous slab of
vocabulary rows (``slab_plan``) that it streams through a ring of
shared-memory stages with bulk asynchronous copies, while it quantizes the
activation rows itself (the TPU entry's ``quantize_act``, inside the launch:
the wrapper runs no op before it); the dot loops take four packed rows a warp
against every activation row with ``__dp4a``.

``head4_logits`` takes the twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import int8_matmul, quantize_act, quantize_weight_mse
from . import build
from .decode_layer import MAX_BATCH, MAX_ROW_BYTES, pack4, unpack4
from .nar_fused import H100_SMS, _sms

SOURCES = build.LIBRARIES["head4"]
STAGE_ROWS = 32             # packed rows a ring stage: 8 warps x 4 rows
RING_BYTES = 160 * 1024     # the most shared memory the ring takes

# Launches of the CUDA kernel in this process (reset with reset_launch_count).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def pack_head4(w):
    """(V, K) weight -> (wp (V, K/2) int8 packed int4, ws (2, V) f32): each
    half of K quantized on its own with the int4 clip search. K must be a
    multiple of 32."""
    V, K = w.shape
    if K % 32:
        raise ValueError(f"head4 needs K a multiple of 32, got {K}")
    wf = w.detach().float()
    ql, sl = quantize_weight_mse(wf[:, : K // 2], levels=7)
    qr, sr = quantize_weight_mse(wf[:, K // 2:], levels=7)
    return pack4(ql, qr), torch.stack([sl, sr]).float()


def head4_logits_ref(x, wp, ws, *, n_vocab: int):
    """Plain version of K8: (B, K) activations -> (B, n_vocab) f32."""
    x8, xs = quantize_act(x)
    lo, hi = unpack4(wp)
    kh = lo.shape[1]
    yl = int8_matmul(x8[:, :kh].contiguous(), lo).float()
    yh = int8_matmul(x8[:, kh:].contiguous(), hi).float()
    return ((yl * ws[0] + yh * ws[1]) * xs)[:, :n_vocab]


@functools.lru_cache(maxsize=64)
def slab_plan(v: int, k: int, b: int, sms: int = H100_SMS) -> tuple:
    """(rows_per_block, grid, stages, smem) of one K8 launch over a (v, k/2)
    pack and b activation rows: a block an SM, each a contiguous slab of
    rows_per_block vocabulary rows (the last slab ragged); the ring as many
    stages of ``STAGE_ROWS`` packed rows as the slab has chunks, up to
    ``RING_BYTES``; smem the ring, the b int8 rows, their scales and
    amaxes and the barriers."""
    stage = STAGE_ROWS * (k // 2)
    rows = -(-v // sms)
    grid = -(-v // rows)
    stages = max(1, min(-(-rows // STAGE_ROWS), RING_BYTES // stage))
    return rows, grid, stages, stages * stage + b * k + 8 * MAX_BATCH + 16 * stages


def _lib():
    lib = build.load("head4", SOURCES)
    fn = lib.mars5_head4_logits
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # x, is_f32, wp, ws, out, B, V, K, ws_stride, rows_per_block, grid,
        # stages, smem, stream
        fn.argtypes = [vp, i, vp, vp, vp] + [i] * 8 + [vp]
        fn.restype = ctypes.c_int
        lib.mars5_head4_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_launches() -> int:
    """CUDA kernels the K8 library has launched in this process (one a
    call), counted by its C entry."""
    return _lib().mars5_head4_kernel_launches()


def head4_logits(x, wp, ws, *, n_vocab: int):
    """K8: (B, K) activations -> (B, n_vocab) f32 through the int4 head
    (``pack_head4`` output; more rows than n_vocab are allowed and dropped).

    CPU tensors take ``head4_logits_ref``. CUDA tensors launch the kernel,
    which quantizes the rows itself: 1 to 8 bf16 or f32 activation rows, K a
    multiple of 32 and at most 8192, int8 wp (V, K/2) and f32 ws (2, V), all
    contiguous; anything else raises."""
    if x.device.type == "cpu":
        return head4_logits_ref(x, wp, ws, n_vocab=n_vocab)
    V, kh = wp.shape
    B, K = x.shape[0], x.shape[-1]
    if x.ndim != 2 or not 1 <= B <= MAX_BATCH or not x.is_cuda:
        raise ValueError(f"head4_logits kernel takes 1..{MAX_BATCH} CUDA rows (B, K), got "
                         f"{tuple(x.shape)} on {x.device}")
    if K % 32 or kh != K // 2 or kh > MAX_ROW_BYTES or n_vocab > V:
        raise ValueError(f"head4_logits kernel: x ({B}, {K}) needs K a multiple of 32, "
                         f"K/2 <= {MAX_ROW_BYTES} and wp (>= n_vocab, K/2); got wp "
                         f"{tuple(wp.shape)}")
    if (wp.dtype != torch.int8 or ws.dtype != torch.float32 or ws.shape != (2, V)
            or not (wp.is_cuda and ws.is_cuda and wp.is_contiguous() and ws.is_contiguous())
            or wp.data_ptr() % 16):
        raise ValueError("head4_logits kernel needs contiguous CUDA int8 wp (V, K/2) "
                         "16-byte aligned and f32 ws (2, V)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"head4_logits kernel takes bf16 or f32 rows, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:    # the kernel reads 16-byte row chunks
        x = x.clone(memory_format=torch.contiguous_format)
    rows, grid, stages, smem = slab_plan(V, K, B, _sms(x.device))
    out = torch.empty((B, V), dtype=torch.float32, device=x.device)
    build.call(x.device, _lib().mars5_head4_logits, x.data_ptr(), x.dtype == torch.float32,
               wp.data_ptr(), ws.data_ptr(), out.data_ptr(), B, V, K, V, rows, grid, stages,
               smem)
    global launch_count
    launch_count += 1
    return out if n_vocab == V else out[:, :n_vocab]
