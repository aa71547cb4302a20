"""W8A8 GEMM kernels of the NAR decoder layer, K3 ``fused_linear`` and K4
``fused_ffn`` (``csrc/nar_fused.cu``), and their plain twins.

Replace the TPU kernels ``mars5_tts_tpu/ops/pallas/nar_fused.py::_lin_kernel``
(entry ``fused_linear``) and ``::_ffn_kernel`` (entry ``fused_ffn``) at
``groups=1`` (per-row activation and weight scales):

* ``fused_linear``: [LayerNorm ->] per-row int8 act quant -> int8 x int8 ->
  int32 GEMM -> f32 rescale [+ bias] -> bf16 [+ bf16 residual]. The decoder
  layer runs it for the qkv projection (LN1) and the cross-attention q
  projection (LN2).
* ``fused_ffn``: LayerNorm -> quant -> W and V GEMMs -> bf16 ->
  silu(w) * v in bf16 -> re-quant -> lin2 GEMM -> + bias -> bf16 -> + x.

What bounds them on an H100: at the decoder's M = 2 x 1200 rows the qkv GEMM
is 7.5 G int8 MACs over 3 MB of weights, so both kernels are bound by the
tensor cores and by how often each block re-reads weight tiles from L2. LN
and the per-row amax need whole rows, so a block takes 64 rows, normalises
and quantises them once into shared memory and then walks its share of the
output columns, streaming 64 x 128 int8 weight tiles through a cp.async
double buffer into ``mma.sync.m16n8k32`` (s8 x s8 -> s32). The TPU ``_ffn_kernel``
kept a whole (480 x 6144) intermediate in VMEM; the re-quant of u =
silu(w) * v needs each row's amax over all F columns, which a Hopper block
cannot hold for 64 rows (64 x 3072 bf16 = 384 KB), so K4 is two launches of
the same kernel: the first writes u (M, F) bf16 to device scratch (15 MB at
the bench shape, mostly served from L2), the second re-quantises it with its
own row amax, runs lin2 and adds bias and residual. No wgmma or TMA yet.

Numerics, as in the TPU kernels: LN in f32, rounded to bf16 and back;
``xs = max(amax, 1e-8) / 127``, ``rint(x / xs)`` clipped to +-127; the rescale
``acc * (xs * s)``, the bias in f32, the bf16 cast, then the residual added
in bf16. The integer GEMM is exact and the LN statistics are summed in f64
and rounded once, in kernel and twin alike, so the two differ only through
``expf`` in the sigmoid.

``fused_linear``/``fused_ffn`` take the twins only for CPU tensors. For CUDA
tensors they launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import div, int8_matmul, quantize_act
from . import build

SOURCES = build.LIBRARIES["nar_fused"]
K_CHUNK = 128        # the kernel streams weights in 128-deep k chunks
TILE_N = 64          # output columns per weight tile
MAX_K = 3072         # a 64-row block's int8 A tile must fit in shared memory

# Launches of the CUDA kernels in this process (reset with reset_launch_counts).
fused_linear_launches = 0
fused_ffn_launches = 0


def reset_launch_counts() -> None:
    global fused_linear_launches, fused_ffn_launches
    fused_linear_launches = fused_ffn_launches = 0


# --------------------------------------------------------------- plain twins

def _sum(x):
    """f32 sum over the last axis, accumulated in f64 and rounded once: the
    same f32 value in any order, so the kernels' reductions give it too."""
    return x.double().sum(dim=-1, keepdim=True).float()


def _ln_bf16_f32(xf, w, b, eps):
    """LayerNorm in f32, rounded to bf16 and back (``_ln_bf16_f32``), with
    f64-summed statistics and a correctly rounded 1 / sqrt."""
    k = xf.shape[-1]
    mean = div(_sum(xf), k)
    d = xf - mean
    var = div(_sum(d * d), k)
    y = d * (1.0 / torch.sqrt(var + eps))
    return (y * w.float() + b.float()).to(torch.bfloat16).float()


def _qdot(xf, w):
    """quant -> int8 GEMM -> f32 rescale; xf (M, K) f32, w = (q (N, K), s (N,))."""
    xq, xs = quantize_act(xf)
    return int8_matmul(xq, w[0]).float() * (xs * w[1])


def _silu_mul_bf16(wo, vo):
    """silu(w) * v with both products rounded to bf16."""
    wf = wo.float()
    s = (wf * torch.sigmoid(wf)).to(torch.bfloat16).float()
    return (s * vo.float()).to(torch.bfloat16)


def fused_linear_ref(x, w, *, ln=None, bias=None, residual=None, eps: float = 4e-5):
    """Plain version of K3. x (..., K); w = (q (N, K) int8, s (N,) f32);
    ln = (weight, bias) of a LayerNorm prologue; residual (..., N)."""
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k).float()
    if ln is not None:
        xf = _ln_bf16_f32(xf, ln[0], ln[1], eps)
    y = _qdot(xf, w)
    if bias is not None:
        y = y + bias.float()
    yb = y.to(x.dtype)
    if residual is not None:
        yb = residual.reshape(yb.shape) + yb
    return yb.reshape(*lead, -1)


def fused_ffn_ref(x, ln, w, v, lin2, lin2_b, *, eps: float = 4e-5):
    """Plain version of K4: x + lin2(silu(LN(x) W^T) * LN(x) V^T) with the W8A8
    chain; w, v, lin2 are (q, s) pairs, ln = (weight, bias)."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    h = _ln_bf16_f32(x2.float(), ln[0], ln[1], eps)
    hq, hs = quantize_act(h)
    wo = (int8_matmul(hq, w[0]).float() * (hs * w[1])).to(torch.bfloat16)
    vo = (int8_matmul(hq, v[0]).float() * (hs * v[1])).to(torch.bfloat16)
    y = _qdot(_silu_mul_bf16(wo, vo).float(), lin2) + lin2_b.float()
    return (x2 + y.to(x.dtype)).reshape(*lead, k)


# ------------------------------------------------------------------ kernels

def _lib():
    lib = build.load("nar_fused", SOURCES)
    fn = lib.mars5_w8a8_gemm
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # mode, x, ln_w, ln_b, wq, ws, vq, vs, bias, res, out, M, N, K,
        # tiles_per_block, eps, stream
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


def _aligned(t):
    """t as the kernel reads it: contiguous and 16-byte aligned (vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_w(w, k, what):
    q, s = w
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[1] != k:
        raise ValueError(f"{what}: weight must be int8 (N, {k}), got {q.dtype} "
                         f"{tuple(q.shape)}")
    if s.dtype != torch.float32 or s.shape != (q.shape[0],):
        raise ValueError(f"{what}: scales must be f32 ({q.shape[0]},)")
    return _aligned(q), s.contiguous()


def _tiles_per_block(m, n_cols):
    """Output tiles each block walks: enough blocks to cover the card twice."""
    tiles = n_cols // TILE_N
    m_blocks = -(-m // 64)
    splits = min(tiles, max(1, -(-264 // m_blocks)))
    return -(-tiles // splits)


def _launch(mode, x2, ln, wq, ws, vq, vs, bias, res, out, n, eps):
    m, k = x2.shape
    fn = _lib()
    n_cols = n if mode == 0 else 2 * n   # mode 1 tiles hold 32 W + 32 V rows
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(mode, x2.data_ptr(),
                 None if ln is None else ln[0].data_ptr(),
                 None if ln is None else ln[1].data_ptr(),
                 wq.data_ptr(), ws.data_ptr(),
                 None if vq is None else vq.data_ptr(),
                 None if vs is None else vs.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if res is None else res.data_ptr(),
                 out.data_ptr(), m, n, k, _tiles_per_block(m, n_cols), eps, stream)
    if err != 0:
        raise RuntimeError(f"nar_fused kernel launch failed: cudaError {err}")


def _check_x(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel takes bf16 activations, got {x.dtype}")
    k = x.shape[-1]
    if k % K_CHUNK or k > MAX_K:
        raise ValueError(f"{what} kernel needs K a multiple of {K_CHUNK} and "
                         f"<= {MAX_K}, got {k}")
    return _aligned(x.reshape(-1, k))


def fused_linear(x, w, *, ln=None, bias=None, residual=None, eps: float = 4e-5):
    """K3: [LN ->] W8A8 linear [+ bias] [+ residual] -> (..., N).

    CPU tensors take ``fused_linear_ref``; CUDA tensors launch the kernel
    (bf16 x, K a multiple of 128, N a multiple of 64) and raise otherwise."""
    if x.device.type == "cpu":
        return fused_linear_ref(x, w, ln=ln, bias=bias, residual=residual, eps=eps)
    x2 = _check_x(x, "fused_linear")
    q, s = _check_w(w, x2.shape[1], "fused_linear")
    n = q.shape[0]
    if n % TILE_N:
        raise ValueError(f"fused_linear kernel needs N a multiple of {TILE_N}, got {n}")
    res = None
    if residual is not None:
        if residual.dtype != torch.bfloat16 or residual.shape != (*x.shape[:-1], n):
            raise ValueError("fused_linear: residual must be bf16 (..., N)")
        res = residual.reshape(-1, n).contiguous()
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"fused_linear: bias must be ({n},)")
    if ln is not None:
        ln = (_f32(ln[0]), _f32(ln[1]))
    out = torch.empty((x2.shape[0], n), dtype=torch.bfloat16, device=x.device)
    _launch(0, x2, ln, q, s, None, None, _f32(bias), res, out, n, eps)
    global fused_linear_launches
    fused_linear_launches += 1
    return out.reshape(*x.shape[:-1], n)


def fused_ffn(x, ln, w, v, lin2, lin2_b, *, eps: float = 4e-5):
    """K4: x + lin2(silu(w) * v) over LN(x), W8A8 -> (..., K).

    CPU tensors take ``fused_ffn_ref``; CUDA tensors launch the kernel (two
    launches of ``csrc/nar_fused.cu``, counted as one) and raise on what it
    does not take (bf16 x, K and F multiples of 128)."""
    if x.device.type == "cpu":
        return fused_ffn_ref(x, ln, w, v, lin2, lin2_b, eps=eps)
    x2 = _check_x(x, "fused_ffn")
    m, k = x2.shape
    wq, ws = _check_w(w, k, "fused_ffn W")
    vq, vs = _check_w(v, k, "fused_ffn V")
    f = wq.shape[0]
    if vq.shape[0] != f or f % K_CHUNK or f > MAX_K:
        raise ValueError(f"fused_ffn kernel needs W, V of one width F, a multiple "
                         f"of {K_CHUNK} and <= {MAX_K}")
    l2q, l2s = _check_w(lin2, f, "fused_ffn lin2")
    if l2q.shape[0] != k or lin2_b.shape != (k,):
        raise ValueError(f"fused_ffn: lin2 must map {f} -> {k}")
    u = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    _launch(1, x2, (_f32(ln[0]), _f32(ln[1])), wq, ws, vq, vs, None, None, u, f, eps)
    out = torch.empty_like(x2)
    _launch(0, u, None, l2q, l2s, None, None, _f32(lin2_b), x2, out, k, eps)
    global fused_ffn_launches
    fused_ffn_launches += 1
    return out.reshape(x.shape)
