"""A torch emulation of K1's int8 mode as ``csrc/mha.cu`` runs it, on the CPU.

The kernel (``mars5_mha_int8_fwd``) is three launches: pre-pass one writes
k8 / ks and each 64-key block's per-channel max |v|, pre-pass two vs and v8
transposed with its keys in ``v8_key`` order inside each 32-key block, and
the attention walks 192-query CTAs (three warpgroups of 64 rows) over a
ring of 128-key tiles, pass 1 (the row max) then pass 2 (p, its f32 row
sum, p8 packed from wgmma's s32 accumulator fragment into the s8 A fragment
of O += P8 V8). The emulation below does the same steps on the scratch
layout of ``mha.int8_plan``, with the fragments indexed per warp and lane
as the PTX ISA lays them out (the kernel's other conversions, pass 1's
integer-add s32 -> f32 and p8 from a magic add, give these same values; its
flushing exp2 differs only where p < 2^-126, where p8 is 0 either way), and
is held against the twin
``_mha_int8_ref``: its int32 PV sums equal the twin's ``p8 . v8`` exactly
(the scores, max and p are the same f32 operations), and its output lies
within ``int8_bound`` (only the row sum's order differs). The shapes take
a ragged last CTA (Lq not a multiple of 192), a ragged last tile (Lk not a
multiple of 128), the 66-key cross-attention, a fully masked tail tile and a
row whose keys are all masked but one.
"""

import math

import pytest
import torch

from mars5_tts_torch.ops.kernels import mha as K
from mars5_tts_torch.ops.quant import div

D = K.HEAD_DIM


def _v8_key(p):
    """``v8_key`` of csrc/mha.cu: the key stored at position p of a 32-key
    block of v8t."""
    r, blk = p % 16, p - p % 16
    t, i = r // 4, r % 4
    return blk + 2 * t + i + 6 * (i >= 2)


def _acc_index():
    """(row, key) of wgmma's m64n128k32 s32 accumulator register i of lane 4
    g + t in warp w, as (4, 32, 64) tensors: row 16 w + g + 8 ((i >> 1) & 1),
    key 8 (i >> 2) + 2 t + (i & 1)."""
    w, lane, i = torch.meshgrid(torch.arange(4), torch.arange(32), torch.arange(64),
                                indexing="ij")
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def _a_index():
    """(row, k position) of byte b of the s8 A fragment register a of lane 4
    g + t in warp w (mma m16n8k32's per-warp layout, which wgmma takes from
    registers), as (4, 32, 4, 4) tensors: a0 / a2 row g, a1 / a3 row g + 8;
    a0 / a1 positions 4 t + b, a2 / a3 16 + 4 t + b."""
    w, lane, a, b = torch.meshgrid(torch.arange(4), torch.arange(32), torch.arange(4),
                                   torch.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (a & 1), 16 * (a >> 1) + 4 * t + b


def _pack_target():
    """Where the kernel packs p8 of accumulator i = 4 j + e: (32-key slice j
    >> 2, register ((j & 3) >> 1) * 2 + (e >> 1), byte (j & 1) * 2 + (e &
    1)), as three (64,) tensors."""
    i = torch.arange(64)
    j, e = i // 4, i % 4
    return j >> 2, ((j & 3) >> 1) * 2 + (e >> 1), (j & 1) * 2 + (e & 1)


def _quant_rows(x):
    """The kernels' per-row int8 (``quant127`` of the row's max(amax, 1e-8) /
    127), f32 in, (int64 values, f32 scales)."""
    s = div(x.abs().amax(-1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(x / s).clamp(-127, 127).long(), s[..., 0]


def _scratch_parts(plan):
    """The parts of an int8 scratch of ``plan.scratch_bytes``, as tensors."""
    scratch = torch.zeros(plan.scratch_bytes, dtype=torch.int8)
    return {name: scratch[off:off + math.prod(shape) * dt.itemsize].view(dt).view(shape)
            for name, (off, shape, dt) in plan.parts.items()}


def _prepass(k, v, plan):
    """The two pre-pass launches into an int8 scratch laid out by ``plan``."""
    b, lk, h, _ = k.shape
    bh = b * h
    parts = _scratch_parts(plan)
    kf = k.float().permute(0, 2, 1, 3).reshape(bh, lk, D)
    vf = v.float().permute(0, 2, 1, 3).reshape(bh, lk, D)
    # launch one: k rows, and each 64-key block's per-channel max |v|
    k8, ks = _quant_rows(kf)
    parts["k8"].copy_(k8.to(torch.int8))
    parts["ks"].copy_(ks)
    for kb in range(plan.n_kb):
        blk = vf[:, kb * K.INT8_PRE_KEYS:(kb + 1) * K.INT8_PRE_KEYS]
        parts["vmax"][:, kb] = blk.abs().amax(1)
    # launch two: vs from the blocks' maxima, v8 transposed in v8_key order
    vs = div(parts["vmax"].amax(1).clamp_min(1e-8), 127.0)
    parts["vs"].copy_(vs)
    v8 = torch.round(vf / vs[:, None]).clamp(-127, 127)
    v8 = torch.nn.functional.pad(v8, (0, 0, 0, plan.lkp - lk))
    pos = torch.arange(plan.lkp)
    parts["v8t"].copy_(v8[:, _v8_key(pos)].transpose(1, 2).to(torch.int8))
    return parts


def _emulate(q, k, v, mask):
    """The kernel's output (B, Lq, H, 64) bf16, its int32 PV sums (B, Lq, H,
    64) and the walk's record: [(CTA (bh, query tile), warpgroups run)] and
    the ring's (pass, tile) sequence."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    plan = K.int8_plan(b, lq, lk, h)
    parts = _prepass(k, v, plan)
    bh, n_cta = plan.grids[2]
    n_tiles = -(-lk // K.INT8_KEYS)
    scale = 1.0 / math.sqrt(D)

    # the CTAs' q tiles as TMA lands them (zero rows past Lq); a warpgroup
    # runs when its first row is below Lq
    qf = q.float().permute(0, 2, 1, 3).reshape(bh, lq, D)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, n_cta * K.INT8_QUERIES - lq))
    n_wg = -(-lq // 64)
    walk = [((x, y), min(3, n_wg - 3 * y)) for y in range(n_cta) for x in range(bh)]
    qf = qf[:, :64 * n_wg].reshape(bh, n_wg, 64, D)
    q8, qs = _quant_rows(qf)
    qsc = qs * scale                                         # (bh, W, 64)

    # the ring: per stage k8 / v8t tiles zero-filled past Lk / Lkp, ks (0
    # past Lk) and the 0 / -inf bias the producer writes
    keymask = torch.zeros((b, lk), dtype=torch.bool) if mask is None else mask
    bias = torch.full((b, n_tiles * K.INT8_KEYS), float("-inf"))
    bias[:, :lk] = torch.where(keymask, float("-inf"), 0.0)
    bias = bias.repeat_interleave(h, 0)                      # (bh, keys)
    ksp = torch.nn.functional.pad(parts["ks"], (0, n_tiles * K.INT8_KEYS - lk))
    k8 = torch.nn.functional.pad(parts["k8"].long(), (0, 0, 0, n_tiles * K.INT8_KEYS - lk))
    v8t = torch.nn.functional.pad(parts["v8t"].long(), (0, n_tiles * K.INT8_KEYS - plan.lkp))
    rows, cols = _acc_index()
    a_rows, a_pos = _a_index()
    kk_of, reg_of, byte_of = _pack_target()
    r_of = (torch.arange(64) >> 1) & 1                      # accumulator i -> row g or g + 8

    ring = []

    def scores(t):
        sl = slice(t * K.INT8_KEYS, (t + 1) * K.INT8_KEYS)
        s_int = torch.einsum("bwrd,bkd->bwrk", q8, k8[:, sl])  # exact in int64
        acc = s_int[:, :, rows, cols]                        # (bh, W, 4, 32, 64)
        rowq = torch.gather(qsc, 2, rows.reshape(1, 1, -1).expand(bh, n_wg, -1)).view(acc.shape)
        ks_t, bias_t = ksp[:, sl][:, cols], bias[:, sl][:, cols]    # (bh, 4, 32, 64)
        return (acc.float() * rowq) * ks_t[:, None] + bias_t[:, None]

    # pass 1: each thread's max over its two rows, then over its quad
    mx = torch.full((bh, n_wg, 4, 32, 2), float("-inf"))
    for t in range(n_tiles):
        ring.append((1, t))
        s = scores(t)
        for r in range(2):
            mx[..., r] = torch.maximum(mx[..., r], s[..., r_of == r].amax(-1))
    mx = mx.view(bh, n_wg, 4, 8, 4, 2).amax(4, keepdim=True).expand(-1, -1, -1, -1, 4, -1)
    mx = mx.reshape(bh, n_wg, 4, 32, 2)

    # pass 2: p, the thread's f32 row sums in register order, p8 packed into
    # the A fragments, O += P8 V8t a 32-key slice at a time
    o = torch.zeros((bh, n_wg, 64, D), dtype=torch.int64)
    rs = torch.zeros((bh, n_wg, 4, 32, 2))
    for t in range(n_tiles):
        ring.append((2, t))
        s = scores(t)
        p = torch.exp2((s - mx[..., r_of]) * K.LOG2E)
        for i in range(64):
            rs[..., r_of[i]] += p[..., i]
        p8 = torch.round(p * 127.0).long()
        pa = torch.zeros((bh, n_wg, 4, 32, 4, 4, 4), dtype=torch.int64)   # ..., slice, reg, byte
        pa[..., kk_of, reg_of, byte_of] = p8
        for kk in range(4):
            a = torch.zeros((bh, n_wg, 64, 32), dtype=torch.int64)
            a[:, :, a_rows, a_pos] = pa[..., kk, :, :]
            sl = slice(t * K.INT8_KEYS + 32 * kk, t * K.INT8_KEYS + 32 * (kk + 1))
            o += torch.einsum("bwrp,bcp->bwrc", a, v8t[:, :, sl])
    # the quad's butterfly: + lane ^ 1, then + lane ^ 2
    rs = rs.view(bh, n_wg, 4, 8, 4, 2)
    rs = rs + rs[..., [1, 0, 3, 2], :]
    rs = rs + rs[..., [2, 3, 0, 1], :]
    rsum = torch.empty((bh, n_wg, 64))
    for r in range(2):
        rsum[:, :, 16 * torch.arange(4)[:, None] + torch.arange(8) + 8 * r] = rs[..., 0, r]

    vsd = div(parts["vs"], 127.0)                            # (bh, 64)
    out = (o.float() * vsd[:, None, None]) / rsum[..., None]
    out = out.reshape(bh, n_wg * 64, D)[:, :lq].reshape(b, h, lq, D).permute(0, 2, 1, 3)
    pv = o.reshape(bh, n_wg * 64, D)[:, :lq].reshape(b, h, lq, D).permute(0, 2, 1, 3)
    return out.to(torch.bfloat16), pv, walk, ring


def _inputs(b, lq, lk, h, kind, seed):
    g = torch.Generator().manual_seed(seed)
    q = (2 * torch.randn((b, lq, h, D), generator=g)).to(torch.bfloat16)
    k, v = (torch.randn((b, lk, h, D), generator=g).to(torch.bfloat16) for _ in range(2))
    mask = None
    if kind == "masked":
        mask = torch.zeros((b, lk), dtype=torch.bool)
        mask[-1, lk - lk // 5:] = True
        mask[0, min(3, lk - 1)] = lk > 1
    elif kind == "tail":                 # the last tile(s) of row 1 fully masked
        mask = torch.zeros((b, lk), dtype=torch.bool)
        mask[1, 140:] = True
    elif kind == "one":                  # row 0 keeps one key
        mask = torch.zeros((b, lk), dtype=torch.bool)
        mask[0] = True
        mask[0, lk // 2] = False
    return q, k, v, mask


CASES = [
    (2, 200, 200, 2, "masked"),          # ragged last CTA (8 rows) and ragged last tile (72 keys)
    (2, 150, 66, 2, "masked"),           # the cross-attention's 66 keys: one ragged tile
    (2, 100, 300, 2, "tail"),            # keys 256-299 of row 1 all masked
    (2, 70, 130, 2, "one"),              # row 0 attends to one key
    (1, 192, 256, 3, None),              # whole CTAs and tiles
    (1, 1, 1, 1, None),
]


@pytest.mark.parametrize("b,lq,lk,h,kind", CASES)
def test_int8_walk_matches_the_twin(b, lq, lk, h, kind):
    q, k, v, mask = _inputs(b, lq, lk, h, kind, seed=lq + lk)
    got, pv, _, _ = _emulate(q, k, v, mask)
    ref, vs, r, pv_ref = K._mha_int8_ref(q, k, v, mask, stats=True)
    assert torch.equal(pv.double(), pv_ref)
    ref, tol = K.int8_bound(q, k, v, mask)
    err = (got.float() - ref.float()).abs()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert bool((err <= tol).all()), (err - tol).max().item()


@pytest.mark.parametrize("b,lq,lk,h,kind", CASES[:4])
def test_int8_walk_covers_ctas_and_both_passes(b, lq, lk, h, kind):
    """Each query row lies in one warpgroup of one 192-query CTA, the grid
    is ``int8_plan``'s, the ragged CTA runs only its warpgroups below Lq, and
    the ring walks every 128-key tile in pass 1, then again in pass 2."""
    q, k, v, mask = _inputs(b, lq, lk, h, kind, seed=1)
    _, _, walk, ring = _emulate(q, k, v, mask)
    plan = K.int8_plan(b, lq, lk, h)
    bh, n_cta = plan.grids[2]
    assert [cta for cta, _ in walk] == [(x, y) for y in range(n_cta) for x in range(bh)]
    spans = sorted((192 * y, min(192 * y + 64 * n, lq)) for (x, y), n in walk if x == 0)
    assert [row for lo, hi in spans for row in range(lo, hi)] == list(range(lq))
    assert walk[-1][1] == -(-(lq - 192 * (n_cta - 1)) // 64)
    n = -(-lk // K.INT8_KEYS)
    assert ring == [(1, t) for t in range(n)] + [(2, t) for t in range(n)]


def test_fragment_layouts_move_no_register():
    """The accumulator's keys of one lane and one 32-key slice are exactly
    the keys its A fragment's bytes stand for under ``v8_key``: packing p8
    into the A operand needs no shuffle."""
    rows, cols = _acc_index()
    a_rows, a_pos = _a_index()
    kk_of, reg_of, byte_of = _pack_target()
    for w in range(4):
        for lane in range(32):
            for i in range(64):
                kk, reg, byte = kk_of[i], reg_of[i], byte_of[i]
                assert a_rows[w, lane, reg, byte] == rows[w, lane, i]
                assert 32 * kk + _v8_key(int(a_pos[w, lane, reg, byte])) == cols[w, lane, i]
    # every (row, position) of each slice's A operand is packed exactly once
    for w in range(4):
        assert len({(int(a_rows[w, lane, a, b]), int(a_pos[w, lane, a, b]))
                    for lane in range(32) for a in range(4) for b in range(4)}) == 16 * 32
    assert sorted(_v8_key(p) for p in range(32)) == list(range(32))
