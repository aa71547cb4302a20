"""W4A8 output head of the quantized AR decode engine, kernel K8
``head4_logits`` (``csrc/head4.cu``), its plain twin and its pack.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/head4.py::_head4_kernel``
(entry ``head4_logits``): the AR's (n_vocab, dim) output projection read as
nibble-packed int4 (half the int8 head's bytes), with the same convention as
the K2 pack: the low nibble is input column c of the left half, the high
nibble column c + K/2, one int4 scale per output row and half (chosen by the
int4 clip search), per-row int8 activations. ``Mars5TTS(ar_backend="fused4",
head4=True)`` serves through it.

What bounds it on an H100: the weight stream, 18.4 MB a token at 24,000 x
1536, for one activation row; one warp per vocabulary row streams its packed
row once and multiplies with ``__dp4a``.

``head4_logits`` takes the twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import int8_matmul, quantize_act, quantize_weight_mse
from . import build
from .decode_layer import MAX_ROW_BYTES, pack4, unpack4

SOURCES = build.LIBRARIES["head4"]

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


def _lib():
    lib = build.load("head4", SOURCES)
    fn = lib.mars5_head4_logits
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp]   # x8, xs, wp, ws, out, V, K, ws_stride, stream
        fn.restype = ctypes.c_int
    return fn


def head4_logits(x, wp, ws, *, n_vocab: int):
    """K8: (1, K) activations -> (1, n_vocab) f32 through the int4 head
    (``pack_head4`` output; more rows than n_vocab are allowed and dropped).

    CPU tensors take ``head4_logits_ref``. CUDA tensors launch the kernel:
    one activation row, K a multiple of 32 and at most 8192, int8 wp
    (V, K/2) and f32 ws (2, V), all contiguous; anything else raises."""
    if x.device.type == "cpu":
        return head4_logits_ref(x, wp, ws, n_vocab=n_vocab)
    V, kh = wp.shape
    K = x.shape[-1]
    if x.ndim != 2 or x.shape[0] != 1 or not x.is_cuda:
        raise ValueError(f"head4_logits kernel takes one CUDA row (1, K), got "
                         f"{tuple(x.shape)} on {x.device}")
    if K % 32 or kh != K // 2 or kh > MAX_ROW_BYTES or n_vocab > V:
        raise ValueError(f"head4_logits kernel: x (1, {K}) needs K a multiple of 32, "
                         f"K/2 <= {MAX_ROW_BYTES} and wp (>= n_vocab, K/2); got wp "
                         f"{tuple(wp.shape)}")
    if (wp.dtype != torch.int8 or ws.dtype != torch.float32 or ws.shape != (2, V)
            or not (wp.is_cuda and ws.is_cuda and wp.is_contiguous() and ws.is_contiguous())
            or wp.data_ptr() % 16):
        raise ValueError("head4_logits kernel needs contiguous CUDA int8 wp (V, K/2) "
                         "16-byte aligned and f32 ws (2, V)")
    x8, xs = quantize_act(x)
    x8 = x8.contiguous()
    xs = xs.contiguous()
    out = torch.empty((1, V), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(x8.data_ptr(), xs.data_ptr(), wp.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 V, K, V, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"head4 kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out[:, :n_vocab]
