"""The diffusion tail, K5 ``diffusion_tail``, and the folded-heads GEMM +
diffusion tail in one kernel, K6 ``heads_diffusion_tail``
(``csrc/diffusion_tail.cu``), their plain twins and the per-step posterior
scalars.

Replaces the TPU kernel
``mars5_tts_tpu/ops/pallas/diffusion_tail.py::_heads_tail_kernel`` (entry
``heads_diffusion_tail``): for each generated frame and lane, the folded int8
head logits of the cond and uncond rows (rounded to bf16), the f32 CFG
combine, the tempered log-softmax, the RePaint posterior
log_add_exp(log_x0 + a, b1) (log_x0 itself at t = 0) plus the two-scalar x_t
leg, and a Gumbel-max draw from the given uniforms; only the indices leave
the kernel.

What bounds it on an H100: at the bench shape (2 CFG rows x 750 frames x 7
lanes x 1025 classes, D = 1024) one call does 11 G int8 MACs (11.1 us at the
int8 peak) against 7 MB of folded weights and reads 21.5 MB of uniforms. The
log-sum-exp must be final before the Gumbel argmax (the hot/cold select and
the noise are not monotone in the logit), and all classes of 32 frames are
131 KB of f32: a block holding them leaves room for few weight stages and
one block an SM, with nothing to overlap its tail. So K6 is two launches
from one C call (``heads_tail_plan``): a heads GEMM, a block taking 32
frames of one lane, their cond and uncond int8 rows by TMA as one 64-row
``wgmma`` operand, the lane's weights in 64-class tiles by TMA through a
ring (each tile feeding 64 activation rows; two blocks an SM, one wave), the
epilogue combining cond and uncond in registers and writing the tempered
f32 logits to a scratch laid out as the uniforms (21.5 MB, within the 50 MB
L2); then the tail kernel K5 runs on f32 input, a warp a (frame, lane) row.
The 63 padded classes of the last tile (1025 = 16 x 64 + 1) are never
written nor read, so they never enter the max, the sum or the argmax
(``class_tile_mask``). Drawing the uniforms in the kernel (Philox) would
break the shared-uniform parity with the JAX package, so they stay an input.

K5 replaces ``mars5_tts_tpu/ops/pallas/diffusion_tail.py::_tail_kernel``
(entry ``diffusion_tail``), the second program of the JAX two-program chain
(``MARS5_FUSED_HEADTAIL=0``): the same tail from the bf16 head logits that
``models/nar.nar_heads_folded`` computes. It is bound by memory: at the bench
shape it reads 21.5 MB of logits and 21.5 MB of uniforms (13 us at 3.35 TB/s).
A block stages 8 consecutive (frame, lane) rows, combined and tempered, in
shared memory with 16-byte loads and runs the very ``__device__`` tail of
K6, so K5 is K6 without the heads GEMM and picks the same indices from the
same logits. The class axis is read
unpadded (the TPU's 1152-lane padding and its -1e30 bias do not carry over).

``diffusion_tail`` and ``heads_diffusion_tail`` take their twins only for
CPU tensors. For CUDA tensors they launch the kernel or raise; nothing falls
back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..quant import div, int8_matmul
from . import build

SOURCES = build.LIBRARIES["diffusion_tail"]
MAX_CLASSES = 2048   # the tail's (8 rows x classes) f32 tile in shared memory
SMEM_LIMIT = 232_448         # shared memory a block may use on an H100 (227 KB)
SMEM_TWO_BLOCKS = 115_712    # a block's share when two fit an SM (228 KB, 1 KB each reserved)
FRAMES = 32                  # K6: frames a block (64 wgmma rows: cond and uncond)
CLASS_TILE = 64              # K6: classes a weight tile (the wgmma width)
K_SLICE = 128                # K6: bytes of D a TMA box and ring stage take
MAX_STAGES = 12              # K6: weight tiles in flight, at most


@dataclass(frozen=True)
class HeadsTailPlan:
    """K6's first launch, the heads GEMM: ``grid`` (frame blocks, lanes,
    batch rows), ``class_tiles`` weight tiles of ``CLASS_TILE`` classes (the
    last one zero-padded), a ring of ``stages`` tiles, and its dynamic shared
    memory: the activation rows (64 x D bytes), the ring (``stages`` x 64 x
    128 bytes), the barriers and 1 KB for the 1024-byte alignment. The
    second launch, the tail, takes 8 rows a block."""

    grid: tuple
    class_tiles: int
    stages: int
    smem_bytes: int


def heads_tail_plan(bs: int, length: int, n_lanes: int, n_classes: int,
                    dim: int) -> HeadsTailPlan:
    """The K6 plan for (bs, L) frames of ``n_lanes`` lanes, ``n_classes``
    classes, width ``dim``: as many ring stages as let two blocks share an SM
    (one wave at the bench shape), or, when fewer than three would, as many
    as fit one block an SM, at most ``MAX_STAGES``. Raises when D is not a
    multiple of ``K_SLICE`` or two stages do not fit."""
    if dim % K_SLICE or dim <= 0:
        raise ValueError(f"heads_diffusion_tail kernel needs D a multiple of {K_SLICE}, got {dim}")
    if n_classes > MAX_CLASSES:
        raise ValueError(f"heads_diffusion_tail kernel takes K <= {MAX_CLASSES}, got {n_classes}")

    def smem(n):
        return (dim // K_SLICE) * 64 * K_SLICE + n * 64 * K_SLICE + 8 * (2 * n + 1) + 1024

    fits = [n for n in range(2, MAX_STAGES + 1) if smem(n) <= SMEM_TWO_BLOCKS]
    if not fits or fits[-1] < 3:
        fits = [n for n in range(2, MAX_STAGES + 1) if smem(n) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"heads_diffusion_tail kernel: D {dim} does not fit a block's shared "
                         f"memory")
    stages = fits[-1]
    return HeadsTailPlan(grid=(-(-length // FRAMES), n_lanes, bs),
                         class_tiles=-(-n_classes // CLASS_TILE), stages=stages,
                         smem_bytes=-(-smem(stages) // 16) * 16)


def class_tile_mask(n_classes: int) -> torch.Tensor:
    """(class_tiles * CLASS_TILE,) bool: the classes K6's tiles cover that
    exist. The rest are zero-filled weight rows of the last tile, kept out of
    the max, the sum and the argmax."""
    tiles = -(-n_classes // CLASS_TILE)
    return torch.arange(tiles * CLASS_TILE) < n_classes

# Launches of the CUDA kernels in this process (reset with reset_launch_count):
# K6 in launch_count, K5 in tail_launch_count.
launch_count = 0
tail_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, tail_launch_count
    launch_count = tail_launch_count = 0


def tail_scalars(diff, t: int, use_gumbel: bool = True) -> torch.Tensor:
    """(8,) f32 [a, b1, hot, cold, is_t0, use_gumbel, 0, 0] for reverse step
    t, with the float ops of ``MultinomialDiffusion.q_posterior_indexed``;
    ``use_gumbel=False`` (0) makes the tail take the posterior's argmax (the
    greedy last step)."""
    tm1 = max(t - 1, 0)
    a = diff.log_cumprod_alpha[tm1]
    b1 = diff.log_1_min_cumprod_alpha[tm1] - diff.log_num_classes
    hot, cold = diff._hot_cold(diff.log_alpha[t],
                               diff.log_1_min_alpha[t] - diff.log_num_classes)
    rest = torch.tensor([float(t == 0), float(use_gumbel), 0.0, 0.0], device=a.device)
    return torch.cat([torch.stack([a, b1, hot, cold]), rest])


def tail_scores(x8, xs, folded, u0, x_t, scalars, *, w: float, temp: float):
    """The plain version's per-class scores (bs, L, n, K), whose argmax K6
    returns; arguments as ``heads_diffusion_tail_ref``."""
    rows, length, d = x8.shape
    n, nq, _ = folded["q"].shape
    y = int8_matmul(x8, folded["q"].reshape(n * nq, d)).float()
    y = y * (xs * folded["s"].reshape(-1)) + folded["b"].reshape(-1)
    return logit_scores(y.to(torch.bfloat16).reshape(rows, length, n, nq), u0, x_t, scalars,
                        w=w, temp=temp)


def logit_scores(logits, u0, x_t, scalars, *, w: float, temp: float):
    """The per-class scores (bs, L, n, K) of the tail from head logits (rows,
    L, n, K), whose argmax K5 returns; arguments as ``diffusion_tail_ref``."""
    from ...diffusion.multinomial import log_add_exp

    bs, nq = u0.shape[0], logits.shape[-1]
    z = logits.float()
    z = w * z[:bs] + (1.0 - w) * z[bs:] if z.shape[0] == 2 * bs else z
    # log-softmax with the denominator summed in f64 and rounded once, as the
    # kernels sum it: the same f32 value in any order
    e = div(z, temp)
    e = e - e.amax(dim=-1, keepdim=True)
    log_x0 = e - torch.log(e.exp().double().sum(dim=-1, keepdim=True).float())
    a, b1, hot, cold, is_t0, use_g = scalars[:6]
    lev = torch.where(is_t0 > 0.5, log_x0, log_add_exp(log_x0 + a, b1))
    col = torch.arange(nq, device=z.device)
    un = lev + torch.where(col == x_t[..., None], hot, cold)
    g = -torch.log(torch.clamp(-torch.log(torch.clamp(u0, min=1e-7)), min=1e-7))
    return un + g * use_g


def heads_diffusion_tail_ref(x8, xs, folded, u0, x_t, scalars, *, w: float,
                             temp: float):
    """Plain version of K6.

    x8 (rows, L, D) int8 and xs (rows, L, 1) f32: the normalised, quantised
    decoder output (``nar_heads_prequant``), cond rows then uncond rows when
    rows = 2 * bs; folded: ``fold_quant_heads`` dict, q (n, K, D) int8, s/b
    (n, K) f32; u0 (bs, L, n, K) f32 uniforms; x_t (bs, L, n) current
    indices; scalars from ``tail_scalars``. Returns (bs, L, n) int64: ties
    go to the lowest class.
    """
    return torch.argmax(tail_scores(x8, xs, folded, u0, x_t, scalars, w=w, temp=temp),
                        dim=-1)


def diffusion_tail_ref(logits, u0, x_t, scalars, *, w: float, temp: float):
    """Plain version of K5.

    logits (rows, L, n, K): the folded heads' logits (``nar_heads_folded``),
    cond rows then uncond rows when rows = 2 * bs (the CFG combine runs in
    f32; ``w`` counts only then); u0, x_t and scalars as
    ``heads_diffusion_tail_ref``. Returns (bs, L, n) int64: ties go to the
    lowest class.
    """
    return torch.argmax(logit_scores(logits, u0, x_t, scalars, w=w, temp=temp), dim=-1)


def kernel_launches() -> int:
    """CUDA kernels the K5/K6 library has launched in this process (K6: two
    a call, K5: one), counted by its C entries."""
    fn = build.load("diffusion_tail", SOURCES).mars5_diffusion_tail_kernel_launches
    fn.restype = ctypes.c_longlong
    return fn()


def _lib(entry):
    lib = build.load("diffusion_tail", SOURCES)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if entry == "mars5_heads_diffusion_tail":
            # x8, xs, q, s, b, u0, x_t, scalars, out, z, bs, rows, L, n_lanes,
            # K, D, w, temp, frame_blocks, class_tiles, stages, smem, stream
            fn.argtypes = [vp] * 10 + [i] * 6 + [f, f] + [i] * 4 + [vp]
        else:
            # logits, u0, x_t, scalars, out, bs, rows, L, n_lanes, K, w, temp,
            # stream
            fn.argtypes = [vp] * 5 + [i] * 5 + [f, f, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_tail_args(u0, x_t, scalars, bs, rows, length, n, nq, what):
    if rows not in (bs, 2 * bs):
        raise ValueError(f"{what}: rows must be bs or 2 * bs")
    if tuple(u0.shape) != (bs, length, n, nq) or tuple(x_t.shape) != (bs, length, n):
        raise ValueError(f"{what}: u0 must be {(bs, length, n, nq)} and x_t "
                         f"{(bs, length, n)}")
    if u0.dtype != torch.float32 or scalars.dtype != torch.float32:
        raise ValueError(f"{what}: u0 and scalars must be f32")
    if scalars.shape != (8,):
        raise ValueError(f"{what}: scalars must be (8,)")


def diffusion_tail(logits, u0, x_t, scalars, *, w: float, temp: float):
    """K5: sampled x_{t-1} indices (bs, L, n_lanes) int64 from the folded
    heads' logits; arguments as ``diffusion_tail_ref``.

    CPU tensors take the twin; CUDA tensors launch the kernel and raise on
    what it does not take (bf16 logits, K <= 2048)."""
    if logits.device.type == "cpu":
        return diffusion_tail_ref(logits, u0, x_t, scalars, w=w, temp=temp)
    if logits.device.type != "cuda":
        raise ValueError(f"diffusion_tail: unsupported device {logits.device}")
    if logits.dtype != torch.bfloat16 or logits.ndim != 4:
        raise ValueError("diffusion_tail kernel takes bf16 logits (rows, L, n, K)")
    rows, length, n, nq = logits.shape
    bs = u0.shape[0]
    if nq > MAX_CLASSES:
        raise ValueError(f"diffusion_tail kernel takes K <= {MAX_CLASSES}, got {nq}")
    _check_tail_args(u0, x_t, scalars, bs, rows, length, n, nq, "diffusion_tail")
    args = [logits.contiguous(), u0.contiguous(), x_t.to(torch.int64).contiguous(),
            scalars.contiguous()]
    out = torch.empty((bs, length, n), dtype=torch.int64, device=logits.device)
    fn = _lib("mars5_diffusion_tail")
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), bs, rows, length, n, nq,
                 float(w) if rows == 2 * bs else 1.0, float(temp), stream)
    if err != 0:
        raise RuntimeError(f"diffusion_tail kernel launch failed: cudaError {err}")
    global tail_launch_count
    tail_launch_count += 1
    return out


def heads_diffusion_tail(x8, xs, folded, u0, x_t, scalars, *, w: float, temp: float):
    """K6: sampled x_{t-1} indices (bs, L, n_lanes) int64 for the generated
    lanes; arguments as ``heads_diffusion_tail_ref``.

    CPU tensors take the twin; CUDA tensors launch the kernel and raise on
    what it does not take (D a multiple of 128, x8 and q contiguous on a
    16-byte boundary, a plan that fits shared memory: ``heads_tail_plan``)."""
    if x8.device.type == "cpu":
        return heads_diffusion_tail_ref(x8, xs, folded, u0, x_t, scalars, w=w, temp=temp)
    if x8.device.type != "cuda":
        raise ValueError(f"heads_diffusion_tail: unsupported device {x8.device}")
    rows, length, d = x8.shape
    q, s, b = folded["q"], folded["s"], folded["b"]
    n, nq, dq = q.shape
    bs = u0.shape[0]
    if x8.dtype != torch.int8 or q.dtype != torch.int8 or dq != d:
        raise ValueError("heads_diffusion_tail: x8 and q must be int8 with one width D")
    plan = heads_tail_plan(bs, length, n, nq, d)
    if xs.shape != (rows, length, 1):
        raise ValueError("heads_diffusion_tail: xs must be (rows, L, 1)")
    _check_tail_args(u0, x_t, scalars, bs, rows, length, n, nq, "heads_diffusion_tail")
    for t in (xs, s, b):
        if t.dtype != torch.float32:
            raise ValueError("heads_diffusion_tail: xs, s, b must be f32")
    for t, what in ((x8, "x8"), (q, "q")):          # read through TMA tensor maps
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"heads_diffusion_tail: {what} must be contiguous and 16-byte "
                             f"aligned")
    args = [t.contiguous() for t in (x8, xs, q, s, b, u0)]
    args += [x_t.to(torch.int64).contiguous(), scalars.contiguous()]
    out = torch.empty((bs, length, n), dtype=torch.int64, device=x8.device)
    z = torch.empty(u0.shape, dtype=torch.float32, device=x8.device)   # the tempered logits
    fn = _lib("mars5_heads_diffusion_tail")
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), z.data_ptr(), bs, rows, length,
                 n, nq, d, float(w) if rows == 2 * bs else 1.0, float(temp), plan.grid[0],
                 plan.class_tiles, plan.stages, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"heads_diffusion_tail kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out
