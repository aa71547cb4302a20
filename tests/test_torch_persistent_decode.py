"""K2's host plan and its attention split, checked without a card.

``decode_layer.persistent_plan`` fixes which rows of every matrix each block
of the persistent step streams and how its shared memory is laid out;
``attention_split`` cuts each (row, head)'s ring slots into chunks over the
grid. The kernel takes both as given. A torch emulation of the split (slot
chunks, per-chunk maxima, the denominator summed per 64-slot tile in f64
and the tiles in a fixed order, int32 PV partials) is held bit for bit against the plain twin's
``_attention``.
"""

import math

import numpy as np
import pytest
import torch

from mars5_tts_torch.ops.kernels import decode_layer as D
from mars5_tts_torch.ops.quant import div, quantize_act

RELEASED = dict(n_layers=26, dim=1536, hidden=3584, n_heads=24, head_dim=64, window=2001)
TINY = dict(n_layers=3, dim=256, hidden=512, n_heads=4, head_dim=64, window=24)


def _dims(geometry, wbits, batch=1):
    return D.FusedDims(**geometry, wbits=wbits, batch=batch)


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("batch", range(1, 9))
@pytest.mark.parametrize("geometry,sm_count", [(RELEASED, 132), (TINY, 132), (TINY, 5)])
def test_plan_tiles_every_matrix_once(geometry, sm_count, wbits, batch):
    """Each phase's row ranges cover its rows exactly once, in order, each
    slice starts on a 16-byte boundary of the pack, and the buffers of any
    two consecutive phases and the activation rows fit a block's 227 KB."""
    dims = _dims(geometry, wbits, batch)
    plan = D.persistent_plan(dims, batch, sm_count)
    assert plan.grid == sm_count
    rb = D.row_bytes(dims)
    for k, (n, bounds) in enumerate(zip(D.phase_rows(dims), plan.rows)):
        assert len(bounds) == plan.grid + 1 and bounds[0] == 0 and bounds[-1] == n
        sizes = np.diff(bounds)
        assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1
        assert all(r * rb[k] % 16 == 0 for r in bounds)
        per = 2 if D.PHASES[k] == "w13" else 1
        assert plan.slice_bytes[k] == sizes.max() * rb[k] * per
    buf = (plan.off_norm, plan.off_act - plan.off_b)       # A: wqkv, w13; B: wo, w2
    assert plan.off_b - plan.off_norm >= 4 * dims.dim       # the A phases' RMSNorm weight
    for k in range(4):                                      # the layer's phases, then the next's
        now, nxt = plan.slice_bytes[k], plan.slice_bytes[(k + 1) % 4]
        assert now <= buf[k % 2] and nxt <= buf[(k + 1) % 2]
        assert now + nxt <= D.SMEM_LIMIT
    assert plan.off_norm % 16 == plan.off_b % 16 == plan.off_act % 16 == plan.off_vec % 16 == plan.off_x8 % 16 == 0
    assert plan.off_vec - plan.off_act >= 4 * batch * dims.dim
    assert plan.off_x8 - plan.off_vec >= 4 * dims.dim
    assert plan.smem_bytes - plan.off_x8 >= batch * max(dims.dim, dims.hidden)
    assert plan.smem_bytes + D.STATIC_SMEM <= D.SMEM_LIMIT


def test_plan_at_the_released_widths():
    """W8, one row, an H100's 132 SMs: the slices the design counts on."""
    plan = D.persistent_plan(_dims(RELEASED, 8), 1, 132)
    assert plan.slice_bytes == (35 * 1536, 12 * 1536, 2 * 28 * 1536, 12 * 3584)
    assert plan.phase_rows(0, 0) == (0, 34) and plan.phase_rows(2, 131) == (3556, 3584)


@pytest.mark.parametrize("geometry,wbits,batch,sm_count,match", [
    (RELEASED, 8, 8, 40, "shared memory"),          # slices too large for a small grid
    (dict(TINY, dim=200, n_heads=3), 8, 1, 132, "multiple of 16"),
    (dict(TINY, hidden=8192), 8, 1, 132, "multiple of 16 bytes up to"),
    (dict(TINY, hidden=6144), 4, 1, 132, "hidden up to"),
    (dict(TINY, dim=2560, n_heads=40), 4, 1, 132, "dim up to"),
    (TINY, 8, 9, 132, "rows"),
    (TINY, 8, 1, 0, "at least one block"),
])
def test_plan_refuses_what_does_not_fit(geometry, wbits, batch, sm_count, match):
    dims = _dims(geometry, wbits)
    with pytest.raises(ValueError, match=match):
        D.persistent_plan(dims, batch, sm_count)


@pytest.mark.parametrize("batch,slots,want", [
    (1, 601, (128, 5)), (1, 1901, (384, 5)), (1, 1, (64, 1)), (1, 2001, (448, 5)),
    (4, 2001, (2048, 1)), (8, 700, (704, 1)), (2, 130, (128, 2)),
])
def test_attention_split(batch, slots, want):
    """Chunks of whole 64-slot tiles, as many a (row, head) as the grid has
    blocks for (132 // (rows x 24 heads)), covering the slots."""
    chunk, n = D.attention_split(132, batch, 24, slots)
    assert (chunk, n) == want
    assert chunk % D.SLOT_TILE == 0 and (n - 1) * chunk < slots <= n * chunk
    assert batch * 24 * n <= max(132, batch * 24)


def test_scratch_layout():
    dims = _dims(RELEASED, 4, 4)
    lay = D.scratch_layout(dims, 4, 2001, 132, 3)
    names = ("qkv", "u", "uamax", "scores", "pmax", "pamax", "selfs", "stats", "pv", "psum")
    offs = [lay[n] for n in names] + [lay["bytes"]]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert lay["u"] - lay["qkv"] == 4 * 4 * 3 * 1536
    assert lay["bytes"] - lay["psum"] == 8 * 4 * 24 * math.ceil(2001 / 64)


# ----------------------------------------------------- the split, emulated

def _split_attention(q, k_new, v, ck, cv, ks, vs, pos, dims, chunk):
    """The kernel's three attention steps for one row, chunk by chunk: step 1
    scores and a max per chunk, step 2 p = exp(s - m) with the global max,
    the f64 sum of each 64-slot tile and the amax of p * vs per chunk, step 3
    int8 PV partials per chunk in int32; then the wo prologue's combine."""
    H, Dh, W = dims.n_heads, dims.head_dim, dims.window
    scale = 1.0 / math.sqrt(Dh)
    qh, kh, vh = q.view(H, Dh), k_new.view(H, Dh), v.view(H, Dh)
    q8, qms = quantize_act(qh)
    self_s = D._self_scores(qh, kh, scale)                       # (H, 1)
    n, cur = min(pos + 1, W), pos % W
    chunks = [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
    kc = ck.view(-1, H, Dh).double()
    scores = torch.full((H, n), float("-inf"))
    pmax = []
    for lo, hi in chunks:                                          # step 1
        acc = torch.einsum("hd,whd->hw", q8.double(), kc[lo:hi]).float()   # exact
        s = acc * qms * ks[lo:hi][None] * scale
        if lo <= cur < hi:
            s[:, cur - lo] = float("-inf")
        scores[:, lo:hi] = s
        pmax.append(s.amax(dim=-1, keepdim=True))
    m = torch.maximum(torch.cat(pmax, dim=-1).amax(dim=-1, keepdim=True), self_s)
    p = torch.exp(scores - m)                                      # step 2
    tiles = [p[:, t:t + D.SLOT_TILE].double().sum(dim=-1, keepdim=True)
             for t in range(0, n, D.SLOT_TILE)]
    pvs = p * vs[:n][None]
    pamax = [pvs[:, lo:hi].abs().amax(dim=-1, keepdim=True) for lo, hi in chunks]
    ps = div(torch.cat(pamax, dim=-1).amax(dim=-1, keepdim=True).clamp(min=1e-8), 127.0)
    pv8 = torch.round(pvs / ps).clamp(-127, 127).double()          # step 3
    vc = cv.view(-1, H, Dh).double()
    pv = sum(torch.einsum("hw,whd->hd", pv8[:, lo:hi], vc[lo:hi]) for lo, hi in chunks)
    lanes = [torch.zeros_like(tiles[0]) for _ in range(32)]        # lane l: tiles l, l + 32, ...
    for i, t in enumerate(tiles):
        lanes[i % 32] = lanes[i % 32] + t
    for o in (16, 8, 4, 2, 1):                                     # the warp's butterfly
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    total = lanes[0]
    p_self = torch.exp(self_s - m)
    denom = total.float() + p_self
    out = pv.float() * ps
    return (out / denom + (p_self / denom) * vh).reshape(1, -1)


@pytest.mark.parametrize("pos,chunk", [
    (20, 64), (600, 128), (600, 192), (1900, 384), (2400, 448), (2400, 2048), (0, 64),
    (2000, 64),
])
def test_split_attention_equals_the_twin(pos, chunk):
    """Ragged chunks (the last one short, or past the valid slots), before
    and after the ring wraps (window 2001; pos 2400 and 2000 wrapped): the
    split's output equals ``_attention`` bit for bit."""
    dims = _dims(dict(RELEASED, n_layers=1), 8)
    rng = np.random.default_rng(pos + chunk)
    d, w = dims.dim, dims.window
    q, k, v = (torch.from_numpy(rng.standard_normal((1, d), np.float32)) for _ in range(3))
    (ck, ks), (cv, vs) = (D.quantize_kv_rows(torch.from_numpy(
        rng.standard_normal((w, d), np.float32) * 0.1)) for _ in range(2))
    valid = D._ring_valid(pos, w, w, q.device)
    want = D._attention(q, k, v, ck, cv, ks, vs, valid, dims)
    got = _split_attention(q, k, v, ck, cv, ks, vs, pos, dims, chunk)
    assert torch.equal(got, want)
