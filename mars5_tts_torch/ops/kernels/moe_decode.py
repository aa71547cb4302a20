"""The routed-expert SwiGLU of one decode step, kernel K10 ``moe_decode``
(``csrc/moe_decode.cu``), and its plain twin.

K10 has no TPU counterpart: it came with the DeepSeek-V2 block
(``models/ar.py``, ``MoEFeedForward``), which the JAX package does not run.
For rows b of x (B, D), each with k expert ids and weights (the router's top
k, left on the device):

    y_b = sum_k p_bk W2_e (silu(W1_e x_b) * W3_e x_b) + S(x_b),   e = ids[b, k]

with each expert's W1 over its W3 in ``w13`` (E, 2F, D) and its W2 in ``w2``
(E, D, F), and S the shared experts' SwiGLU (``w1s``, ``w3s`` (Fs, D),
``w2s`` (D, Fs)), or nothing. The sum runs in f32 and rounds once.

What bounds it on an H100: bytes. At DeepSeek-V2-Lite's widths one row reads
6 routed experts and the shared pair, 138.4 MB a layer, 41.3 us at 3.35
TB/s. Eager PyTorch offers two ways, both worse: read the ids to the host (a
sync a layer, then a launch per expert), or gather each row's experts (a
copy of B k experts' weights, twice the traffic). The kernel
reads the ids and weights on the device and each distinct expert's weights
once for all the rows that chose it: two launches a call (an up pass a warp
per (expert, inner channel), a down pass a warp per output channel that
then sums each row's slots), see the header of ``csrc/moe_decode.cu``.

Numerics (kernel and twin alike): each dot product is a sum of exact
products taken in f64 and rounded to f32 once; silu(a) = a / (1 + exp(-a))
and h = silu(a) * b in f32; a row's slots summed in its k order, acc = acc
+ p * y with a rounding each, the shared experts last; one rounding to x's
dtype. The two agree bit for bit except where an f64 sum in another order
lands across an f32 rounding boundary: then by one ulp of the output
(``one_ulp``).

``moe_decode`` takes the twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; nothing falls back. ``load`` (E,) int32, when
given, gets one count a routed slot, on the device (the expert-load tally
of ``models/ar_decode``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCES = build.LIBRARIES["moe_decode"]
MAX_ROWS = 8          # the kernel's rows (bits of a row mask)
MAX_K = 8             # experts a row
MAX_EXPERTS = 64      # the routing table's mask
MAX_DIM = 2048        # x's rows in the up pass's shared memory
DIM_STEP = 256        # D a multiple of: 32 lanes x 8 bf16
INNER_STEP = 8        # F, Fs multiples of: 16-byte chunks

# Calls of the CUDA kernel in this process (reset with reset_launch_count).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _swiglu(xd, w1, w3, w2):
    """(B, D) f32 rows of one expert's SwiGLU of f64 rows ``xd``: f64 dots
    rounded to f32 once, silu and the product in f32."""
    a = (xd @ w1.double().t()).float()
    b = (xd @ w3.double().t()).float()
    h = a / (1.0 + torch.exp(-a)) * b
    return (h.double() @ w2.double().t()).float()


def moe_decode_ref(x, ids, weights, w13, w2, w1s=None, w3s=None, w2s=None, load=None):
    """Plain version of K10. x (B, D); ids (B, k) integer; weights (B, k)
    f32; w13 (E, 2F, D), w2 (E, D, F); the shared experts' w1s, w3s (Fs, D)
    and w2s (D, Fs), or None. Returns (B, D) in x's dtype; adds a count a
    routed slot into ``load`` (E,) when given."""
    f = w2.shape[-1]
    xd = x.double()
    ids = ids.long()
    y = {int(e): _swiglu(xd, w13[e, :f], w13[e, f:], w2[e]) for e in torch.unique(ids).tolist()}
    rows = torch.arange(x.shape[0], device=x.device)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(ids.shape[1]):
        yk = torch.stack([y[int(e)][r] for r, e in zip(rows.tolist(), ids[:, k].tolist())])
        acc = acc + weights[:, k:k + 1].float() * yk
    if w1s is not None:
        acc = acc + _swiglu(xd, w1s, w3s, w2s)
    if load is not None:
        load.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), dtype=load.dtype,
                                                        device=load.device))
    return acc.to(x.dtype)


def one_ulp(got, want):
    """The stated tolerance between K10 and its twin, per element: one ulp
    of the output dtype at the larger magnitude of the two (an f64 sum that
    lands on the other side of an f32 rounding boundary moves an f32 value
    by one ulp, and so the bf16 output by at most one)."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    a = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(2.0 ** -120)
    return torch.exp2(torch.floor(torch.log2(a)) - mant)


def _lib():
    lib = build.load("moe_decode", SOURCES)
    fn = lib.mars5_moe_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # x, ids, w, w13, w2, s1, s3, s2, h, out, load, B, K, E, D, F, Fs, stream
        fn.argtypes = [vp] * 11 + [i] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn


def launch_args(x, ids, weights, w13, w2, w1s=None, w3s=None, w2s=None, load=None):
    """(B, k, E, D, F, Fs) for the kernel; raises ValueError on what it does
    not take: 1-8 contiguous bf16 rows of D a multiple of 256 up to 2,048;
    int32 ids and f32 weights (B, k), k <= 8; up to 64 contiguous bf16
    experts of F (and shared experts of Fs, all three or none) a multiple of
    8; an int32 (E,) ``load`` or None; every tensor on x's device, 16-byte
    aligned."""
    b, d = x.shape
    e, f2, d2 = w13.shape
    f = f2 // 2
    k = ids.shape[-1]
    fs = 0 if w1s is None else w1s.shape[0]
    dev = x.device
    if (x.dtype != torch.bfloat16 or not 1 <= b <= MAX_ROWS or d % DIM_STEP or d > MAX_DIM
            or not x.is_contiguous()):
        raise ValueError(f"moe_decode kernel takes 1..{MAX_ROWS} contiguous bf16 rows of a "
                         f"multiple of {DIM_STEP} up to {MAX_DIM}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if (ids.dtype != torch.int32 or ids.shape != (b, k) or not 1 <= k <= MAX_K
            or weights.dtype != torch.float32 or weights.shape != (b, k)
            or not (ids.is_contiguous() and weights.is_contiguous())):
        raise ValueError(f"moe_decode kernel takes contiguous int32 ids and f32 weights "
                         f"({b}, k <= {MAX_K}), got {ids.dtype} {tuple(ids.shape)} and "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if (not 1 <= e <= MAX_EXPERTS or d2 != d or f2 % 2 or f % INNER_STEP
            or w2.shape != (e, d, f)):
        raise ValueError(f"moe_decode kernel takes w13 (E <= {MAX_EXPERTS}, 2F, {d}) and w2 "
                         f"(E, {d}, F), F a multiple of {INNER_STEP}; got {tuple(w13.shape)} "
                         f"and {tuple(w2.shape)}")
    shared = (w1s, w3s, w2s)
    if any(t is None for t in shared) != all(t is None for t in shared):
        raise ValueError("moe_decode: give all three shared-expert weights, or none")
    if w1s is not None and (fs % INNER_STEP or w1s.shape != (fs, d) or w3s.shape != (fs, d)
                            or w2s.shape != (d, fs)):
        raise ValueError(f"moe_decode kernel takes shared w1s, w3s (Fs, {d}) and w2s ({d}, "
                         f"Fs), Fs a multiple of {INNER_STEP}")
    weights_all = [w13, w2] + ([] if w1s is None else list(shared))
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in weights_all):
        raise ValueError("moe_decode kernel takes contiguous bf16 expert weights")
    if load is not None and (load.dtype != torch.int32 or load.shape != (e,)
                             or not load.is_contiguous()):
        raise ValueError(f"moe_decode: load must be a contiguous int32 ({e},) tensor")
    tensors = [x, ids, weights] + weights_all + ([] if load is None else [load])
    if any(t.device != dev for t in tensors) or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("moe_decode kernel takes tensors on one device, 16-byte aligned")
    return b, k, e, d, f, fs


def moe_decode(x, ids, weights, w13, w2, w1s=None, w3s=None, w2s=None, load=None):
    """K10: one decode step's routed experts and shared experts; arguments
    as ``moe_decode_ref``. CPU tensors take ``moe_decode_ref``. CUDA tensors
    launch the kernel and raise on what it does not take (``launch_args``)."""
    if x.device.type == "cpu":
        return moe_decode_ref(x, ids, weights, w13, w2, w1s, w3s, w2s, load)
    if x.device.type != "cuda":
        raise ValueError(f"moe_decode: unsupported device {x.device}")
    b, k, e, d, f, fs = launch_args(x, ids, weights, w13, w2, w1s, w3s, w2s, load)
    h = torch.empty((b * k + 1, b, max(f, fs)), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptr = (lambda t: None if t is None else t.data_ptr())
    build.call(x.device, _lib(), x.data_ptr(), ids.data_ptr(), weights.data_ptr(),
               w13.data_ptr(), w2.data_ptr(), ptr(w1s), ptr(w3s), ptr(w2s), h.data_ptr(),
               out.data_ptr(), ptr(load), b, k, e, d, f, fs)
    global launch_count
    launch_count += 1
    return out
