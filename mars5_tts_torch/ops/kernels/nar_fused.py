"""W8A8 GEMM kernels of the NAR decoder layer, K3 ``fused_linear`` and K4
``fused_ffn`` (``csrc/nar_fused.cu`` over ``csrc/w8a8_wgmma.cuh``), and their
plain twins.

Replace the TPU kernels ``mars5_tts_tpu/ops/pallas/nar_fused.py::_lin_kernel``
(entry ``fused_linear``) and ``::_ffn_kernel`` (entry ``fused_ffn``), with
per-row activation and weight scales (``groups=1``) or per K group
(``groups`` > 1, the fidelity mode of ``quantize_nar(w_gsize=)``):

* ``fused_linear``: [LayerNorm ->] per-row int8 act quant -> int8 x int8 ->
  int32 GEMM -> f32 rescale [+ bias] -> bf16 [+ bf16 residual]. The decoder
  layer runs it for the qkv projection (LN1) and the cross-attention q
  projection (LN2).
* ``fused_ffn``: LayerNorm -> quant -> W and V GEMMs -> bf16 ->
  silu(w) * v in bf16 -> re-quant -> lin2 GEMM -> + bias -> bf16 -> + x.

What bounds them on an H100: at the decoder's M = 2 x 1200 rows the qkv GEMM
is 7.5 G int8 MACs over 3 MB of weights, so both kernels are bound by the
tensor cores, which only ``wgmma`` drives at their rate, and then by how many
bytes each tile pulls from L2. Each call is a per-row prologue (one warp a
row: [LN,] amax, int8 row and f32 scale into scratch, once a row) and a
persistent, warp-specialised GEMM: one producer thread feeds 128-deep int8
slices of A and W by TMA into a shared-memory ring, two consumer warpgroups
run ``wgmma.m64nNk32`` (s8 x s8 -> s32) on tiles of 128 rows by 256 or 128
weight rows and apply the epilogue in registers. The TPU ``_ffn_kernel``
kept a whole (480 x 6144) intermediate in VMEM; the re-quant of u =
silu(w) * v needs each row's amax over all F columns, which a Hopper CTA
cannot hold for its rows, so K4 writes u (M, F) bf16 to device scratch
(15 MB at the bench shape, mostly served from L2) and quantises it with a
second prologue before lin2: four launches from one C call. ``gemm_plan``
is the host's choice of a GEMM launch's tile width and persistent grid.
x and the residual are read as contiguous (M, C) rows, the LN and bias
vectors as they are when all of a call's are bf16 (the decoder's are) or
all f32.

Numerics, as in the TPU kernels: LN in f32, rounded to bf16 and back;
``xs = max(amax, 1e-8) / 127``, ``rint(x / xs)`` clipped to +-127; the rescale
``acc * (xs * s)``, the bias in f32, the bf16 cast, then the residual added
in bf16. The integer GEMM is exact and the LN statistics are summed in f64
and rounded once, in kernel and twin alike, so the two differ only through
``expf`` in the sigmoid.

Grouped (JAX ``_qdot`` with ``groups`` > 1): the activations are quantized
per (row, group of K / groups columns), scales (M, G); each group's int32
partial becomes ``(acc * xs_g) * sg[g]`` for weights with group scales sg
(G, N), or ``acc * xs_g`` for per-row weights (times s after the sum); the
partials are summed in group order from the first, then the bias, the cast
and the residual as above. The kernels fold each group's int32 partial into
an f32 sum (a group a multiple of 32 columns, one s8 wgmma step) from one of
two accumulator sets while the next group's products are in flight, and
take 64- or 128-wide tiles, whichever's last wave ends first by the rows a
tile pulls (``gemm_plan``).

``fused_linear``/``fused_ffn`` take the twins only for CPU tensors. For CUDA
tensors they launch the kernels or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import div, int8_matmul, quantize_act
from . import build

SOURCES = build.LIBRARIES["nar_fused"]
K_CHUNK = 128        # the GEMM streams 128-deep k slices (one 128-byte swizzle row)
N_MULTIPLE = 64      # output columns: a multiple of 64 (tiles may be ragged)
MAX_K = 3072         # a prologue warp holds a row of up to 3072 values in registers
TILE_M = 128         # rows a GEMM tile: two consumer warpgroups of 64
TILE_B = (256, 128)  # weight rows a GEMM tile, the wider first (K4's W and V GEMM: half each)
TILE_B_GROUPED = (128, 64)   # the grouped kernels' (two accumulator sets and a sum)
GROUP_MULTIPLE = 32  # a K group of the grouped kernels: whole s8 wgmma steps (32 deep)
H100_SMS = 132

# Launches of the CUDA kernels in this process, and of those the grouped
# ones (reset with reset_launch_counts).
fused_linear_launches = 0
fused_ffn_launches = 0
fused_linear_grouped_launches = 0
fused_ffn_grouped_launches = 0


def reset_launch_counts() -> None:
    global fused_linear_launches, fused_ffn_launches
    global fused_linear_grouped_launches, fused_ffn_grouped_launches
    fused_linear_launches = fused_ffn_launches = 0
    fused_linear_grouped_launches = fused_ffn_grouped_launches = 0


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


def check_groups(k: int, groups: int, s) -> int:
    """The group size K / groups of a GEMM over K columns with weight scales
    ``s``: (N,) per row, or (groups, N) per K group (one group, (1, N), is
    per row). Raises ValueError when groups does not divide K or ``s`` fits
    neither (JAX ``_qdot``)."""
    if groups < 1 or k % groups:
        raise ValueError(f"nar_fused: groups {groups} does not divide K={k}")
    if s.ndim == 2 and s.shape[0] not in (groups, 1):
        raise ValueError(f"nar_fused: weight scale groups {s.shape[0]} != activation groups "
                         f"{groups}")
    if s.ndim not in (1, 2):
        raise ValueError(f"nar_fused: scales must be (N,) or (G, N), got {tuple(s.shape)}")
    return k // groups


def _qdot(xf, w, groups: int = 1):
    """quant -> int8 GEMM -> f32 rescale; xf (M, K) f32, w = (q (N, K), s),
    s (N,) per row or (G, N) per K group. groups = 1: ``acc * (xs * s)``.
    groups > 1 (JAX ``_qdot``): per (row, group) activation scales, each
    group's int32 partial rescaled ``(acc * xs_g) * s[g]`` (or ``acc *
    xs_g`` with per-row weight scales, multiplied by s after the sum), the
    groups summed in order from the first."""
    q, s = w
    gs = check_groups(xf.shape[-1], groups, s)
    if s.ndim == 2 and s.shape[0] == 1:      # one weight group: a scale a row
        s = s[0]
    if groups == 1:
        xq, xs = quantize_act(xf)
        return int8_matmul(xq, q).float() * (xs * s)
    out = None
    for g in range(groups):
        sl = slice(g * gs, (g + 1) * gs)
        xq, xs = quantize_act(xf[:, sl])
        part = int8_matmul(xq, q[:, sl].contiguous()).float() * xs
        if s.ndim == 2:
            part = part * s[g]
        out = part if out is None else out + part
    return out if s.ndim == 2 else out * s


def _silu_mul_bf16(wo, vo):
    """silu(w) * v with both products rounded to bf16."""
    wf = wo.float()
    s = (wf * torch.sigmoid(wf)).to(torch.bfloat16).float()
    return (s * vo.float()).to(torch.bfloat16)


def fused_linear_ref(x, w, *, ln=None, bias=None, residual=None, eps: float = 4e-5,
                     groups: int = 1):
    """Plain version of K3. x (..., K); w = (q (N, K) int8, s) with s (N,)
    f32, or (groups, N) with ``groups`` K groups; ln = (weight, bias) of a
    LayerNorm prologue; residual (..., N)."""
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k).float()
    if ln is not None:
        xf = _ln_bf16_f32(xf, ln[0], ln[1], eps)
    y = _qdot(xf, w, groups)
    if bias is not None:
        y = y + bias.float()
    yb = y.to(x.dtype)
    if residual is not None:
        yb = residual.reshape(yb.shape) + yb
    return yb.reshape(*lead, -1)


def fused_ffn_ref(x, ln, w, v, lin2, lin2_b, *, eps: float = 4e-5, groups: int = 1,
                  groups2: int | None = None):
    """Plain version of K4: x + lin2(silu(LN(x) W^T) * LN(x) V^T) with the W8A8
    chain; w, v, lin2 are (q, s) pairs, ln = (weight, bias). ``groups`` K
    groups for the W and V GEMM, ``groups2`` (default ``groups``) F groups
    for lin2, as ``fused_linear_ref`` takes them."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    h = _ln_bf16_f32(x2.float(), ln[0], ln[1], eps)
    wo = _qdot(h, w, groups).to(torch.bfloat16)
    vo = _qdot(h, v, groups).to(torch.bfloat16)
    y = _qdot(_silu_mul_bf16(wo, vo).float(), lin2,
              groups if groups2 is None else groups2) + lin2_b.float()
    return (x2 + y.to(x.dtype)).reshape(*lead, k)


def prologue_ref(x, ln=None, eps: float = 4e-5):
    """Plain version of the kernels' per-row prologue: x (M, K) [-> LN] ->
    (q (M, K) int8, xs (M,) f32), the twins' ``_ln_bf16_f32`` and
    ``quantize_act``."""
    xf = x.float()
    if ln is not None:
        xf = _ln_bf16_f32(xf, ln[0], ln[1], eps)
    q, xs = quantize_act(xf)
    return q, xs[..., 0]


# ------------------------------------------------------------------ host plan

def check_gemm(m: int, n: int, k: int, mode: int) -> None:
    """Raises ValueError on a GEMM the kernels of ``w8a8_wgmma.cuh`` do not
    take: mode 0 or 1, K a multiple of 128 up to MAX_K, N a multiple of 64."""
    if mode not in (0, 1):
        raise ValueError(f"nar_fused: no GEMM mode {mode}")
    if m <= 0:
        raise ValueError("nar_fused: no rows")
    if k <= 0 or k % K_CHUNK or k > MAX_K:
        raise ValueError(f"nar_fused kernel needs K a multiple of {K_CHUNK} and <= {MAX_K}, "
                         f"got {k}")
    if n <= 0 or n % N_MULTIPLE:
        raise ValueError(f"nar_fused kernel needs N a multiple of {N_MULTIPLE}, got {n}")


def wave_plan(m: int, n: int, k: int, mode: int, widths: tuple, sms: int,
              a_rows: int = 0) -> tuple:
    """(tile_b, grid) of a GEMM launch, of the tile widths ``widths`` (widest
    first) the one whose last wave ends first: cost = ceil(tiles / sms) x a
    tile's time, taken as the rows its stages pull, tile_b weight rows and
    ``a_rows`` rows of A (0: a tile's time as its width, K9's sites; TILE_M:
    as the bytes it moves, the grouped GEMMs). A tie keeps the wider tile,
    which moves fewer bytes a product. In mode 1 a width is
    taken only where its tile_b / 2 u columns divide n. The persistent grid
    is min(tiles, sms). Raises ValueError on a shape the kernels do not take
    (``check_gemm``)."""
    check_gemm(m, n, k, mode)
    tiles_m = -(-m // TILE_M)
    best = None
    for bn in widths:
        cols = bn if mode == 0 else bn // 2
        if mode == 1 and n % cols:
            continue
        tiles = tiles_m * -(-n // cols)
        cost = -(-tiles // sms) * (a_rows + bn)
        if best is None or cost < best[0]:
            best = (cost, bn, min(tiles, sms))
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def gemm_plan(m: int, n: int, k: int, mode: int, sms: int = H100_SMS,
              grouped: bool = False) -> tuple:
    """(tile_b, grid) of one GEMM launch over A (m, k) int8 and weights
    (n, k) int8, mode 0 writing (m, n), mode 1 (K4's W and V GEMM) u (m, n)
    from n rows of W and n of V: the weight rows a tile and the persistent
    CTAs, each walking tiles grid apart. The wider 256-row tile moves a
    quarter fewer bytes per product than the 128-row one; it is taken when
    its tiles still give every SM one (and, in mode 1, its 128 u columns
    divide n). A grouped GEMM takes the 128- or the 64-row tile whose last
    wave ends first, a tile's time taken as the A and weight rows its stages
    pull (``wave_plan(a_rows=TILE_M)``; by width, the decoder's sites took
    64-row tiles that were no faster on the card than 128-row ones in fewer
    rounds); its f32 sums beside two int32 accumulator sets fit a consumer's
    registers up to 128. The kernels derive the tiles and TMA boxes from
    tile_b. Raises ValueError on a shape they do not take (``check_gemm``)."""
    if grouped:
        return wave_plan(m, n, k, mode, TILE_B_GROUPED, sms, TILE_M)
    check_gemm(m, n, k, mode)
    tiles_m = -(-m // TILE_M)
    for bn in TILE_B:
        cols = bn if mode == 0 else bn // 2
        tiles = tiles_m * -(-n // cols)
        if tiles >= sms and (mode == 0 or n % cols == 0):
            break
    return bn, min(tiles, sms)


def xs_pitch(m: int) -> int:
    """The row pitch of the grouped kernels' activation scales (G, pitch) in
    the scratch, passed to the kernels with it: m rounded up to 4 floats, so
    each row starts on 16 bytes (the GEMM copies a tile's rows of a group in
    one bulk copy)."""
    return -(-m // 4) * 4


def _rows(t, what) -> int:
    """The number of rows of ``t`` (..., C), which the kernels read as
    contiguous (M, C) rows on a 16-byte boundary (C is a multiple of 64).
    Raises ValueError on any other layout."""
    if t.numel() == 0:
        raise ValueError(f"{what}: no rows")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernels read contiguous rows, got shape "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the rows do not start on a 16-byte boundary")
    return t.numel() // t.shape[-1]


def _vectors(*vecs):
    """A call's LN and bias vectors, (tensor or None, length, name) each, as
    the kernels read them, and whether they are bf16: as given when all are
    bf16 (the decoder's are) or all f32, else f32 copies (bf16 to f32 is
    exact); contiguous on a 16-byte boundary."""
    for t, n, name in vecs:
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    bf16 = all(t.dtype == torch.bfloat16 for t, _, _ in vecs if t is not None)
    out = []
    for t, _, _ in vecs:
        if t is not None:
            t = t.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
            t = t if t.data_ptr() % 16 == 0 else t.clone()
        out.append(t)
    return out, bf16


# ------------------------------------------------------------------ kernels

@functools.lru_cache(maxsize=None)
def _sm_count(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def _sms(device) -> int:
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def _lib():
    lib = build.load("nar_fused", SOURCES)
    if lib.mars5_w8a8_linear.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # x, ln_w, ln_b, bias, vec_bf16, eps, wq, ws, res, out, scratch, M, N,
        # K, grid, tile_b, gsize, w_grouped, xs_pitch, stream
        lib.mars5_w8a8_linear.argtypes = [vp, vp, vp, vp, i, f, vp, vp, vp, vp, vp,
                                          i, i, i, i, i, i, i, i, vp]
        # x, ln_w, ln_b, l2b, vec_bf16, eps, wq, ws, vq, vs, l2q, l2s, u, out,
        # scratch, M, K, F, grid1, tile_b1, grid2, tile_b2, gsize1, w1_grouped,
        # gsize2, w2_grouped, xs_pitch, stream
        lib.mars5_w8a8_ffn.argtypes = [vp, vp, vp, vp, i, f, vp, vp, vp, vp, vp, vp, vp,
                                       vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, vp]
        lib.mars5_w8a8_linear.restype = lib.mars5_w8a8_ffn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_w(w, k, what, groups=1):
    """(q, s) as the kernels read them, and whether s is per K group; raises
    ValueError on what they do not take."""
    q, s = w
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[1] != k:
        raise ValueError(f"{what}: weight must be int8 (N, {k}), got {q.dtype} "
                         f"{tuple(q.shape)}")
    n = q.shape[0]
    if s.dtype != torch.float32 or s.shape not in ((n,), (1, n), (groups, n)):
        raise ValueError(f"{what}: scales must be f32 ({n},), (1, {n})"
                         + (f" or ({groups}, {n})" if groups > 1 else "")
                         + f", got {s.dtype} {tuple(s.shape)}")
    if s.ndim == 2 and s.shape[0] == 1:       # one weight group: a scale a row
        s = s[0]
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{what}: TMA reads the weight as a contiguous (N, K) matrix on a "
                         f"16-byte boundary")
    s = s.contiguous()
    if s.ndim == 2 and s.data_ptr() % 16:     # the GEMM copies its rows in bulk
        s = s.clone()
    return q, s, s.ndim == 2


def _gsize(k, groups, what):
    """Columns a group of a GEMM over K, as the kernels take it; raises
    ValueError on a group count they do not take."""
    if groups < 1 or k % groups:
        raise ValueError(f"{what}: groups {groups} does not divide K={k}")
    gsize = k // groups
    if groups > 1 and gsize % GROUP_MULTIPLE:
        raise ValueError(f"{what}: the kernels take groups of a multiple of {GROUP_MULTIPLE} "
                         f"columns, got {gsize}")
    return gsize


def _check_x(x, what):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel takes bf16 activations, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return _rows(x, f"{what} x")


def fused_linear(x, w, *, ln=None, bias=None, residual=None, eps: float = 4e-5,
                 groups: int = 1):
    """K3: [LN ->] W8A8 linear [+ bias] [+ residual] -> (..., N). ``groups`` >
    1 quantizes the activations per (row, K group) and takes w's scales per
    row (N,) or per group (groups, N) (JAX ``fused_linear(groups=)``).

    CPU tensors take ``fused_linear_ref``; CUDA tensors launch the kernels
    (bf16 x and residual as contiguous rows, K a multiple of 128 up to 3072,
    N a multiple of 64, a group of K / groups columns a multiple of 32) and
    raise otherwise."""
    if x.device.type == "cpu":
        return fused_linear_ref(x, w, ln=ln, bias=bias, residual=residual, eps=eps,
                                groups=groups)
    m = _check_x(x, "fused_linear")
    k = x.shape[-1]
    gsize = _gsize(k, groups, "fused_linear")
    q, s, w_grouped = _check_w(w, k, "fused_linear", groups)
    n = q.shape[0]
    tile_b, grid = gemm_plan(m, n, k, 0, _sms(x.device), groups > 1)
    if residual is not None:
        if residual.dtype != torch.bfloat16 or residual.shape != (*x.shape[:-1], n):
            raise ValueError("fused_linear: residual must be bf16 (..., N)")
        _rows(residual, "fused_linear residual")
    ln = (None, None) if ln is None else ln
    (lnw, lnb, bias), bf16 = _vectors((ln[0], k, "fused_linear: LN weight"),
                                      (ln[1], k, "fused_linear: LN bias"),
                                      (bias, n, "fused_linear: bias"))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    scratch = torch.empty(m * k + 4 * xs_pitch(m) * groups, dtype=torch.int8, device=x.device)
    build.call(x.device, _lib().mars5_w8a8_linear, x.data_ptr(), _ptr(lnw), _ptr(lnb),
               _ptr(bias), bf16, eps, q.data_ptr(), s.data_ptr(), _ptr(residual),
               out.data_ptr(), scratch.data_ptr(), m, n, k, grid, tile_b, gsize, w_grouped,
               xs_pitch(m))
    global fused_linear_launches, fused_linear_grouped_launches
    fused_linear_launches += 1
    fused_linear_grouped_launches += groups > 1
    return out.reshape(*x.shape[:-1], n)


def fused_ffn(x, ln, w, v, lin2, lin2_b, *, eps: float = 4e-5, groups: int = 1,
              groups2: int | None = None):
    """K4: x + lin2(silu(w) * v) over LN(x), W8A8 -> (..., K); ``groups`` K
    groups for the W and V GEMM and ``groups2`` (default ``groups``) F groups
    for lin2, as ``fused_linear`` takes them.

    CPU tensors take ``fused_ffn_ref``; CUDA tensors launch the kernels (four
    launches from one C call, counted as one) and raise on what they do not
    take (bf16 x as contiguous rows, K and F multiples of 128 up to 3072,
    groups of a multiple of 32 columns)."""
    groups2 = groups if groups2 is None else groups2
    if x.device.type == "cpu":
        return fused_ffn_ref(x, ln, w, v, lin2, lin2_b, eps=eps, groups=groups,
                             groups2=groups2)
    m = _check_x(x, "fused_ffn")
    k = x.shape[-1]
    gsize1 = _gsize(k, groups, "fused_ffn W and V")
    wq, ws, wg1 = _check_w(w, k, "fused_ffn W", groups)
    vq, vs, vg1 = _check_w(v, k, "fused_ffn V", groups)
    f = wq.shape[0]
    if vq.shape[0] != f:
        raise ValueError("fused_ffn: W and V must have one width F")
    if wg1 != vg1:
        raise ValueError("fused_ffn: W and V must both have per-row or both group scales")
    gsize2 = _gsize(f, groups2, "fused_ffn lin2")
    l2q, l2s, wg2 = _check_w(lin2, f, "fused_ffn lin2", groups2)
    if l2q.shape[0] != k:
        raise ValueError(f"fused_ffn: lin2 must map {f} -> {k}")
    sms = _sms(x.device)
    (b1, g1), (b2, g2) = (gemm_plan(m, f, k, 1, sms, groups > 1),
                          gemm_plan(m, k, f, 0, sms, groups2 > 1))
    (lnw, lnb, l2b), bf16 = _vectors((ln[0], k, "fused_ffn: LN weight"),
                                     (ln[1], k, "fused_ffn: LN bias"),
                                     (lin2_b, k, "fused_ffn: lin2 bias"))
    u = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((m, k), dtype=torch.bfloat16, device=x.device)
    scratch = torch.empty(m * max(k, f) + 4 * xs_pitch(m) * max(groups, groups2),
                          dtype=torch.int8, device=x.device)
    build.call(x.device, _lib().mars5_w8a8_ffn, x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(),
               l2b.data_ptr(), bf16, eps, wq.data_ptr(), ws.data_ptr(), vq.data_ptr(),
               vs.data_ptr(), l2q.data_ptr(), l2s.data_ptr(), u.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), m, k, f, g1, b1, g2, b2, gsize1, wg1, gsize2, wg2,
               xs_pitch(m))
    global fused_ffn_launches, fused_ffn_grouped_launches
    fused_ffn_launches += 1
    fused_ffn_grouped_launches += groups > 1 or groups2 > 1
    return out.reshape(x.shape)
