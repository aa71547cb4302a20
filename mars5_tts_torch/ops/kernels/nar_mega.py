"""The whole W8A8 NAR decoder stack in one C call, K9 ``mega_decoder_stack``
(``csrc/nar_mega.cu``), its plain twin and its operand bundle.

Replaces the TPU kernel ``mars5_tts_tpu/ops/pallas/nar_mega.py::_make_kernel``
(entry ``mega_decoder_stack``), which ran all decoder layers as one Pallas
program with the activations resident in VMEM. Per layer, with the x stream
in bf16 throughout:

    LN1 -> per-row int8 quant -> qkv GEMM -> self-attention (key-padding mask)
    -> sa_out GEMM + residual -> LN2 -> ca_q GEMM -> cross-attention over the
    ca_kv GEMM of the memory -> ca_out GEMM + residual -> LN3 -> WV GEMM (2F)
    -> silu(w) * v in bf16 -> requant -> lin2 GEMM + bias + residual

The memory is quantized once per call, not once per layer. The stack's final
LayerNorm stays outside (``models/layers.TransformerDecoder``).

Numerics (the TPU kernel's contract, ``nar_mega.py:30-40``): the int8 GEMMs
are exact in int32 and rescaled as ``acc * (xs * s) + b`` in f32; LayerNorm in
f32 rounded to bf16; per-row quant ``xs = max(amax, 1e-8) / 127`` with true
division. Both attentions are full-row softmax: f32 scores, ``p =
exp2((s - max s) * scale * log2e)``, p rounded to bf16 before PV, and the
normalisation deferred, ``o / sum(p)``. Cross-attention uses this same form,
the documented divergence from the per-layer path, so the kernel is held
against ``mega_decoder_stack_ref`` and not against the per-layer stack. The
LN statistics and the softmax denominators are summed in f64 and rounded to
f32 once, in the kernel and in the twin, so the two give the same f32 value
whatever the order of the sum.

What bounds it on an H100: at the bench geometry (2 x 1200 rows, D = 1024,
F = 3072, 16 layers) one call is 1.21 T int8 ops of GEMM (0.61 ms at 1,979
TOP/s) and 0.19 TFLOP of bf16 self-attention a pass over the keys, over 285
MB of int8 weights (85 us at 3.35 TB/s): bound by the tensor cores. The TPU
program kept the (B, L, D) stream in VMEM across all layers; here one C entry
makes 1 + 15 launches a layer with no PyTorch op between them, and the
activations (x, qkv, the attention output, ca_q, u and the int8 A operand;
about 50 MB at the bench geometry) live in device scratch the wrapper
allocates, most of it served from the 50 MB L2. The seven GEMM sites a layer
are K3/K4's (``csrc/w8a8_wgmma.cuh``): a per-row prologue (LN, int8 row and
scale, once a row) and the persistent, TMA-fed wgmma s8 GEMM, each site's
tile width and grid from ``mega_plan``. Both attentions run on wgmma with a
TMA-fed K/V ring (K1's design) and walk the keys twice, once for the row max
and once for p, the f64 sum and PV, so the softmax is the twin's full-row
form.

``mega_decoder_stack`` takes the twin only for CPU tensors. For CUDA tensors
it launches the kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..quant import int8_matmul, is_quantized, quantize_act
from . import build
from .nar_fused import (H100_SMS, K_CHUNK, MAX_K, TILE_B, TILE_M, _ln_bf16_f32 as _ln,
                        _silu_mul_bf16, _sms, _sum, check_gemm)

SOURCES = build.LIBRARIES["nar_mega"]
HEAD_DIM = 64
LOG2E = 1.4426950408889634
SITES = ("qkv", "sa_out", "ca_q", "ca_kv", "ca_out", "WV", "lin2")   # the GEMM sites a layer
ATTN_KEYS = 128     # keys a ring stage of the attention kernel

# Launches of the C entry in this process, one per stack call (reset with
# reset_launch_count); each is 1 + 15 x n_layers kernels (kernel_launches).
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


@dataclass(frozen=True)
class MegaDims:
    """Static geometry of the stack."""

    n_layers: int
    dim: int             # D
    nhead: int
    hidden: int          # F

    @property
    def head_dim(self) -> int:
        return self.dim // self.nhead

    @property
    def shapes(self):
        """(rows, cols) of the seven int8 weight stages of a layer: qkv, sa_out,
        ca_q, ca_kv, ca_out, WV (W rows, then V rows), lin2 (D, F)."""
        D, F = self.dim, self.hidden
        return ((3 * D, D), (D, D), (D, D), (2 * D, D), (D, D), (2 * F, D), (D, F))

    @property
    def offsets(self):
        """Byte offset of each stage inside a layer's pack row."""
        out, o = [], 0
        for r, c in self.shapes:
            out.append(o)
            o += r * c
        return tuple(out)

    @property
    def layer_bytes(self) -> int:
        return 8 * self.dim ** 2 + 3 * self.hidden * self.dim

    # svec: [qkv 3D | sa_out D | ca_q D | ca_kv 2D | ca_out D | WV 2F | lin2 D]
    @property
    def s_offsets(self):
        D, F = self.dim, self.hidden
        return (0, 3 * D, 4 * D, 5 * D, 7 * D, 8 * D, 8 * D + 2 * F)

    # bvec: [qkv 3D | sa_out D | ca_q D | ca_kv 2D | ca_out D | lin2 D]; WV has none
    @property
    def b_offsets(self):
        D = self.dim
        return (0, 3 * D, 4 * D, 5 * D, 7 * D, None, 8 * D)


@dataclass
class MegaPack:
    """The operand bundle of the whole stack (``build_mega_pack``)."""

    dims: MegaDims
    pack: torch.Tensor      # (n_layers, layer_bytes) int8
    svec: torch.Tensor      # (n_layers, 9D + 2F) f32 weight scales
    bvec: torch.Tensor      # (n_layers, 9D) f32 biases
    lnvec: torch.Tensor     # (n_layers, 6D) f32 LN affines [w1 b1 w2 b2 w3 b3]

    def weight(self, layer: int, stage: int) -> torch.Tensor:
        r, c = self.dims.shapes[stage]
        o = self.dims.offsets[stage]
        return self.pack[layer, o:o + r * c].view(r, c)

    def scale(self, layer: int, stage: int) -> torch.Tensor:
        o = self.dims.s_offsets[stage]
        return self.svec[layer, o:o + self.dims.shapes[stage][0]]

    def bias(self, layer: int, stage: int) -> torch.Tensor:
        o = self.dims.b_offsets[stage]
        return self.bvec[layer, o:o + self.dims.shapes[stage][0]]

    def ln(self, layer: int, i: int):
        D = self.dims.dim
        return (self.lnvec[layer, 2 * i * D:(2 * i + 1) * D],
                self.lnvec[layer, (2 * i + 1) * D:(2 * i + 2) * D])


def _weights(layer):
    """A decoder layer's seven quantized weights: the self- and cross-attention
    in-projections and out-projections, W, V and lin2."""
    sa, ca = layer.self_attn, layer.multihead_attn
    return (sa.in_proj_weight, sa.out_proj.weight, ca.in_proj_weight,
            layer.activation.W.weight, layer.activation.V.weight, ca.out_proj.weight,
            layer.linear2.weight)


def mega_supported(decoder) -> bool:
    """Whether ``decoder`` (a ``TransformerDecoder``) runs on K9: every
    weight W8A8 with per-row scales (no group scales, as JAX
    ``mega_supported`` refuses ``sg``), head dim 64, D and F multiples of 128 and
    at most 3072 (a prologue warp holds a row in registers). The TPU
    program's VMEM estimate and its head-pair and K-chunk conditions are
    TPU layout and do not carry over."""
    layer = decoder.layers[0]
    if not all(is_quantized(w) and not w.grouped for lay in decoder.layers
               for w in _weights(lay)):
        return False
    d = layer.norm1.weight.shape[0]
    f = layer.linear2.weight.q.shape[1]
    return (d // layer.self_attn.nhead == HEAD_DIM and d % layer.self_attn.nhead == 0
            and d % K_CHUNK == 0 and f % K_CHUNK == 0 and d <= MAX_K and f <= MAX_K)


def build_mega_pack(decoder) -> MegaPack:
    """The stacked quantized decoder layers as one operand bundle, on the
    weights' device (``Mars5TTS`` builds it at its first request and keeps
    it)."""
    if not mega_supported(decoder):
        raise ValueError("the decoder stack does not fit the mega kernel (W8A8 per-row "
                         "weights, head dim 64, D and F multiples of 128 up to 3072)")
    layer0 = decoder.layers[0]
    dims = MegaDims(n_layers=len(decoder.layers), dim=layer0.norm1.weight.shape[0],
                    nhead=layer0.self_attn.nhead, hidden=layer0.linear2.weight.q.shape[1])
    D = dims.dim
    packs, svecs, bvecs, lnvecs = [], [], [], []
    for lay in decoder.layers:
        sa_in, sa_out, ca_in, W, V, ca_out, lin2 = _weights(lay)
        mats = (sa_in.q, sa_out.q, ca_in.q[:D], ca_in.q[D:], ca_out.q,
                torch.cat([W.q, V.q]), lin2.q)
        packs.append(torch.cat([m.reshape(-1) for m in mats]))
        svecs.append(torch.cat([sa_in.s, sa_out.s, ca_in.s[:D], ca_in.s[D:], ca_out.s,
                                W.s, V.s, lin2.s]).float())
        bvecs.append(torch.cat([lay.self_attn.in_proj_bias, lay.self_attn.out_proj.bias,
                                lay.multihead_attn.in_proj_bias,
                                lay.multihead_attn.out_proj.bias, lay.linear2.bias]).float())
        lnvecs.append(torch.cat([t.float() for n in (lay.norm1, lay.norm2, lay.norm3)
                                 for t in (n.weight, n.bias)]))
    return MegaPack(dims, torch.stack(packs), torch.stack(svecs), torch.stack(bvecs),
                    torch.stack(lnvecs))


# --------------------------------------------------------------- plain twin

def _gemm(xf, w, s, b=None):
    """quant -> exact int8 GEMM -> ``acc * (xs * s) [+ b]`` in f32."""
    xq, xs = quantize_act(xf)
    y = int8_matmul(xq, w).float() * (xs * s)
    return y if b is None else y + b


def _attn(q, k, v, mask, c2):
    """Full-row softmax attention, q (B, Lq, H, 64) and k/v (B, Lk, H, 64)
    bf16 -> (B, Lq, H * 64) bf16; mask (B, Lk) bool, True = ignore."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2((s - m) * c2)
    r = _sum(p)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), v.float())
    return (o / r).to(torch.bfloat16).permute(0, 2, 1, 3).reshape(*q.shape[:2], -1)


def mega_decoder_stack_ref(mp: MegaPack, x, memory, tgt_key_padding_mask=None,
                           memory_key_padding_mask=None, eps: float = 4e-5):
    """Plain version of K9: x (B, L, D), memory (B, Lk, D) -> (B, L, D) in
    x's dtype, before the stack's final LayerNorm. The stream runs in bf16."""
    dims = mp.dims
    b, l, d = x.shape
    lk = memory.shape[1]
    H, F = dims.nhead, dims.hidden
    c2 = (1.0 / math.sqrt(dims.head_dim)) * LOG2E
    xs = x.to(torch.bfloat16)
    m8, ms = quantize_act(memory.to(torch.bfloat16).float())   # once per call

    def heads(t, n):
        return t.reshape(b, n, H, dims.head_dim)

    for i in range(dims.n_layers):
        w = lambda c: mp.weight(i, c)   # noqa: E731
        s = lambda c: mp.scale(i, c)    # noqa: E731
        bb = lambda c: mp.bias(i, c)    # noqa: E731
        qkv = _gemm(_ln(xs.float(), *mp.ln(i, 0), eps), w(0), s(0), bb(0)).to(torch.bfloat16)
        a = _attn(heads(qkv[..., :d], l), heads(qkv[..., d:2 * d], l),
                  heads(qkv[..., 2 * d:], l), tgt_key_padding_mask, c2)
        xs = xs + _gemm(a.float(), w(1), s(1), bb(1)).to(torch.bfloat16)
        hq = _gemm(_ln(xs.float(), *mp.ln(i, 1), eps), w(2), s(2), bb(2)).to(torch.bfloat16)
        ckv = (int8_matmul(m8, w(3)).float() * (ms * s(3)) + bb(3)).to(torch.bfloat16)
        c = _attn(heads(hq, l), heads(ckv[..., :d], lk), heads(ckv[..., d:], lk),
                  memory_key_padding_mask, c2)
        xs = xs + _gemm(c.float(), w(4), s(4), bb(4)).to(torch.bfloat16)
        wv = _gemm(_ln(xs.float(), *mp.ln(i, 2), eps), w(5), s(5)).to(torch.bfloat16)
        u = _silu_mul_bf16(wv[..., :F], wv[..., F:])
        xs = xs + _gemm(u.float(), w(6), s(6), bb(6)).to(torch.bfloat16)
    return xs.to(x.dtype)


# ------------------------------------------------------------------ host plan

def site_shapes(dims: MegaDims, m: int, mk: int):
    """(M, N, K, mode) of each GEMM site of a layer (``SITES``) over m rows of
    x and mk rows of memory; mode 1 is WV (N = F u columns, from F rows of W
    and F of V)."""
    D, F = dims.dim, dims.hidden
    return ((m, 3 * D, D, 0), (m, D, D, 0), (m, D, D, 0), (mk, 2 * D, D, 0), (m, D, D, 0),
            (m, F, D, 1), (m, D, F, 0))


@functools.lru_cache(maxsize=256)
def site_plan(m: int, n: int, k: int, mode: int, sms: int = H100_SMS) -> tuple:
    """(tile_b, grid) of one K9 GEMM site, as ``nar_fused.gemm_plan`` gives
    K3/K4's but chosen by the wave tail: of the 256- and 128-row tiles, the
    one whose last wave ends first, a tile's time taken as its width
    (rounds = ceil(tiles / sms), cost = rounds x tile_b; a tie keeps the
    wider tile, which moves a quarter fewer bytes a product). The persistent
    grid is min(tiles, sms). Raises ValueError on a shape the kernels do not
    take (``nar_fused.check_gemm``)."""
    check_gemm(m, n, k, mode)
    tiles_m = -(-m // TILE_M)
    best = None
    for bn in TILE_B:
        cols = bn if mode == 0 else bn // 2
        if mode == 1 and n % cols:
            continue
        tiles = tiles_m * -(-n // cols)
        cost = -(-tiles // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, min(tiles, sms))
    return best[1], best[2]


def mega_plan(dims: MegaDims, m: int, mk: int, sms: int = H100_SMS) -> tuple:
    """The (tile_b, grid) of the seven GEMM sites of a layer, in ``SITES``
    order, for m rows of x and mk of memory."""
    return tuple(site_plan(*shape, sms) for shape in site_shapes(dims, m, mk))


def scratch_shapes(dims: MegaDims, b: int, l: int, lk: int):
    """(shape, dtype) of the scratch the kernels take, in the C entry's order:
    qkv, attn, hq, ckv, u (bf16), q8 (the GEMMs' int8 A operand) and xs (its
    row scales), mem8 and ms (the memory, quantized once a call)."""
    D, F = dims.dim, dims.hidden
    m, mk = b * l, b * lk
    bf, s8, f32 = torch.bfloat16, torch.int8, torch.float32
    return (((m, 3 * D), bf), ((m, D), bf), ((m, D), bf), ((mk, 2 * D), bf), ((m, F), bf),
            ((m, max(D, F)), s8), ((m,), f32), ((mk, D), s8), ((mk,), f32))


def kernels_per_call(n_layers: int) -> int:
    """CUDA kernels one K9 call launches: the memory quant, then per layer
    five prologues, the seven GEMM sites and the two attentions."""
    return 1 + 15 * n_layers


# ------------------------------------------------------------------ kernel

def _lib():
    lib = build.load("nar_mega", SOURCES)
    fn = lib.mars5_mega_decoder_stack
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # x, mem, tmask, mmask, pack, svec, bvec, lnvec, qkv, attn, hq, ckv, u,
        # q8, xs, mem8, ms, plan, n_layers, B, L, Lk, D, H, F, eps, c2, stream
        fn.argtypes = [vp] * 17 + [ctypes.POINTER(ctypes.c_int)] + [i] * 7 + [f, f, vp]
        fn.restype = ctypes.c_int
        lib.mars5_mega_kernel_launches.restype = ctypes.c_longlong
    return lib


def kernel_launches() -> int:
    """CUDA kernels the K9 library has launched in this process, counted by
    its C entry (``kernels_per_call`` a call)."""
    return _lib().mars5_mega_kernel_launches()


def _mask_u8(mask, shape, what):
    if mask is None:
        return None
    if mask.dtype != torch.bool or tuple(mask.shape) != shape:
        raise ValueError(f"mega_decoder_stack: {what} must be bool {shape}")
    return mask.to(torch.uint8).contiguous()


def mega_decoder_stack(mp: MegaPack, x, memory, tgt_key_padding_mask=None,
                       memory_key_padding_mask=None, eps: float = 4e-5):
    """K9: the whole quantized decoder stack, (B, L, D) -> (B, L, D) before
    the final LayerNorm; arguments as ``mega_decoder_stack_ref``.

    CPU tensors take the twin; CUDA tensors launch the kernels (bf16 x and
    memory on the pack's device) and raise on what they do not take."""
    if x.device.type == "cpu":
        return mega_decoder_stack_ref(mp, x, memory, tgt_key_padding_mask,
                                      memory_key_padding_mask, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mega_decoder_stack: unsupported device {x.device}")
    dims = mp.dims
    D, F = dims.dim, dims.hidden
    b, l, d = x.shape
    if memory.ndim != 3 or memory.shape[0] != b or d != D or memory.shape[2] != D:
        raise ValueError(f"mega_decoder_stack: x must be (B, L, {D}) and memory "
                         f"(B, Lk, {D}), got {tuple(x.shape)} and {tuple(memory.shape)}")
    if x.dtype != torch.bfloat16 or memory.dtype != torch.bfloat16:
        raise ValueError("mega_decoder_stack kernel takes bf16 x and memory")
    if (dims.head_dim != HEAD_DIM or D % K_CHUNK or F % K_CHUNK or D > MAX_K
            or F > MAX_K):
        raise ValueError("mega_decoder_stack kernel needs head dim 64 and D, F multiples "
                         f"of {K_CHUNK} up to {MAX_K}")
    nl = dims.n_layers
    if (mp.pack.dtype != torch.int8 or tuple(mp.pack.shape) != (nl, dims.layer_bytes)
            or tuple(mp.svec.shape) != (nl, 9 * D + 2 * F)
            or tuple(mp.bvec.shape) != (nl, 9 * D) or tuple(mp.lnvec.shape) != (nl, 6 * D)
            or any(t.dtype != torch.float32 for t in (mp.svec, mp.bvec, mp.lnvec))
            or not all(t.is_contiguous() for t in (mp.pack, mp.svec, mp.bvec, mp.lnvec))
            or any(t.data_ptr() % 16 for t in (mp.pack, mp.svec, mp.bvec, mp.lnvec))):
        raise ValueError("mega_decoder_stack: malformed pack (see build_mega_pack)")
    if any(t.device != x.device for t in (memory, mp.pack, mp.svec, mp.bvec, mp.lnvec)):
        raise ValueError("mega_decoder_stack: x, memory and the pack must share a device")
    lk = memory.shape[1]
    tm = _mask_u8(tgt_key_padding_mask, (b, l), "tgt_key_padding_mask")
    mm = _mask_u8(memory_key_padding_mask, (b, lk), "memory_key_padding_mask")
    plan = mega_plan(dims, b * l, b * lk, _sms(x.device))
    xw = x.contiguous().clone()          # the stream, updated in place by the kernels
    mem = memory.contiguous()
    scratch = [torch.empty(shape, dtype=dt, device=x.device)
               for shape, dt in scratch_shapes(dims, b, l, lk)]
    lib = _lib()
    build.call(x.device, lib.mars5_mega_decoder_stack, xw.data_ptr(), mem.data_ptr(),
               None if tm is None else tm.data_ptr(), None if mm is None else mm.data_ptr(),
               mp.pack.data_ptr(), mp.svec.data_ptr(), mp.bvec.data_ptr(), mp.lnvec.data_ptr(),
               *[t.data_ptr() for t in scratch], (ctypes.c_int * 14)(*sum(plan, ())), nl, b, l,
               lk, D, dims.nhead, F, eps, (1.0 / math.sqrt(HEAD_DIM)) * LOG2E)
    global launch_count
    launch_count += 1
    return xw
