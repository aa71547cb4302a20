"""What the kernels' wrappers decide on the host, checked without a card:
K1's tensor-map eligibility of a view (``mha.tensor_map_strides``) and its
launch arguments, K7's cluster size for a slot count and its launch
arguments, K3/K4's GEMM plan (tile width and persistent grid,
``nar_fused.gemm_plan``), the rows and LN/bias vectors they read, K6's tile
plan (``diffusion_tail.heads_tail_plan``) and its padded classes, and the
refusals of these wrappers on inputs a CPU can build: among them K3/K4's
group sizes and group scales, K1's int8 mode off head dim 64, off bf16 and
off 16-byte views, K9 on grouped weights and ``Mars5TTS``'s NAR options;
K1's int8 plan (``mha.int8_plan``: grids, scratch parts, tensor maps). K2's
plan is in ``test_torch_persistent_decode.py``.
"""

import pytest
import torch

from mars5_tts_torch.ops.kernels import decode_attention as A
from mars5_tts_torch.ops.kernels import mha as K
from mars5_tts_torch.ops.kernels import nar_fused as F


def _qkv_views(b, l, h, dtype=torch.bfloat16):
    qkv = torch.zeros((b, l, 3 * h * 64), dtype=dtype)
    return [qkv[..., i * h * 64:(i + 1) * h * 64].reshape(b, l, h, 64) for i in range(3)]


def test_int8_decoder_views_are_read_in_place():
    """The int8 decoder slices q, k, v out of one (2, 1200, 3072) projection;
    its last layer takes 750 queries: every view qualifies, with its strides."""
    q, k, v = _qkv_views(2, 1200, 16)
    assert K.tensor_map_strides(k) == (1200 * 3072, 3072, 64)
    args = K.launch_args(q[:, 450:], k, v, torch.zeros((2, 1200), dtype=torch.bool))
    assert args == (2, 750, 1200, 16, 64) + (1200 * 3072, 3072, 64) * 3


def test_contiguous_and_size_one_axes_qualify():
    x = torch.zeros((1, 7, 1, 64), dtype=torch.bfloat16)
    assert K.tensor_map_strides(x) == (448, 64, 448)
    assert K.tensor_map_strides(torch.zeros((3, 5, 2, 64))) == (640, 128, 64)


@pytest.mark.parametrize("make,reason", [
    (lambda: torch.zeros((2, 40, 3 * 128 + 8), dtype=torch.bfloat16)[..., 1:129]
     .reshape(2, 40, 2, 64), "16-byte boundary"),
    (lambda: torch.zeros((2, 40, 256), dtype=torch.bfloat16)[..., ::2]
     .reshape(2, 40, 2, 64), "unit stride"),
    (lambda: torch.zeros((2, 40, 2, 68), dtype=torch.bfloat16)[..., :64], "16 bytes"),
    (lambda: torch.zeros((2, 40, 2, 32), dtype=torch.bfloat16), "expected"),
])
def test_ineligible_views_raise(make, reason):
    with pytest.raises(ValueError, match=reason):
        K.tensor_map_strides(make())


@pytest.mark.parametrize("change", ["dtype", "mixed", "shape", "head_dim", "mask_dtype",
                                    "mask_shape"])
def test_mha_launch_args_refuse(change):
    q, k, v = (torch.zeros((2, 30, 3, 64), dtype=torch.bfloat16) for _ in range(3))
    mask = None
    if change == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif change == "mixed":
        v = v.float()
    elif change == "shape":
        v = v[:, :20]
    elif change == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif change == "mask_dtype":
        mask = torch.zeros((2, 30), dtype=torch.uint8)
    else:
        mask = torch.zeros((2, 29), dtype=torch.bool)
    with pytest.raises(ValueError):
        K.launch_args(q, k, v, mask)


def test_mha_refuses_devices_it_has_no_kernel_for():
    q = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.mha(q, q, q)


@pytest.mark.parametrize("n_slots,pairs,cluster", [
    (1, 24, 1), (256, 24, 1), (257, 24, 2), (601, 24, 3), (1792, 24, 7), (1793, 24, 8),
    (2001, 24, 8), (8192, 1, 8),                  # one row of the bf16 AR: slots decide
    (2001, 48, 6), (2001, 96, 3), (2001, 192, 1), (2001, 1000, 1),   # 2, 4, 8 rows: CTAs decide
])
def test_cluster_size(n_slots, pairs, cluster):
    assert A.cluster_size(n_slots, pairs) == cluster


def test_slot_bound_from_host_or_device_positions():
    assert A.slot_bound(600, 2001) == 601
    assert A.slot_bound([5, 4005], 2001) == 2001
    assert A.slot_bound((0, 3), 2001) == 4
    assert A.slot_bound(torch.tensor([600]), 2001) == 2001      # unknown on the host
    assert A.slot_bound(torch.tensor([600]), 2001, max_pos=600) == 601


def _ring(b=2, w=16, h=2, d=64, dtype=torch.bfloat16):
    return (torch.zeros((b, h, d), dtype=dtype), torch.zeros((b, w, h, d), dtype=dtype),
            torch.zeros((b, w, h, d), dtype=dtype), torch.zeros((b, h, d), dtype=dtype),
            torch.zeros((b, h, d), dtype=dtype))


def test_decode_attention_launch_args_size_the_cluster():
    q, ck, cv, kn, vn = _ring(1, 2001, 24)
    assert A.launch_args(q, ck, cv, 0, kn, vn) == (1, 2001, 24, 64, 1)
    assert A.launch_args(q, ck, cv, [600], kn, vn) == (1, 2001, 24, 64, 3)
    assert A.launch_args(q, ck, cv, torch.tensor([600]), kn, vn)[-1] == 8
    assert A.launch_args(q, ck, cv, torch.tensor([600]), kn, vn, max_pos=600)[-1] == 3
    q, ck, cv, kn, vn = _ring(4, 2001, 24)
    assert A.launch_args(q, ck, cv, [600, 1200, 1900, 2400], kn, vn)[-1] == 3


@pytest.mark.parametrize("change", ["head_dim", "dtype", "window", "self_half", "ring_shape",
                                    "ring_dtype", "strided_ring"])
def test_decode_attention_launch_args_refuse(change):
    q, ck, cv, kn, vn = _ring()
    if change == "head_dim":
        q, ck, cv, kn, vn = (t[..., :32] for t in (q, ck, cv, kn, vn))
    elif change == "dtype":
        q, ck, cv, kn, vn = (t.half() for t in (q, ck, cv, kn, vn))
    elif change == "window":
        ck = cv = torch.zeros((2, A.MAX_WINDOW + 1, 2, 64), dtype=torch.bfloat16)
    elif change == "self_half":
        vn = None
    elif change == "ring_shape":
        cv = cv[:, :8]
    elif change == "ring_dtype":
        cv = cv.float()
    else:
        ck = ck.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        A.launch_args(q, ck, cv, [3, 4], kn, vn)


def test_decode_attention_refuses_devices_it_has_no_kernel_for():
    q, ck, cv, _, _ = (t.to("meta") for t in _ring())
    with pytest.raises(ValueError, match="unsupported device"):
        A.decode_attention(q, ck, cv, [3, 4])


# (M, N, K, mode) -> (tile_b, grid): tiles of 128 rows by tile_b weight rows
# (mode 1: tile_b / 2 u columns)
W8A8_PLANS = [
    ((2400, 3072, 1024, 0), (256, 132)),   # K3 qkv: 19 x 12 = 228 tiles
    ((2400, 1024, 1024, 0), (128, 132)),   # K3 caq: 19 x 4 = 76 wide ones, 152 narrow
    ((2400, 3072, 1024, 1), (256, 132)),   # K4 W, V: 19 x 24 tiles of 128 u columns
    ((2400, 1024, 3072, 0), (128, 132)),   # K4 lin2, K = F
    ((1450, 3072, 1024, 0), (256, 132)),   # 725 frames: 12 x 12 = 144
    ((1500, 1024, 1024, 0), (128, 96)),    # the last layer's rows: 12 x 8 tiles
    ((1, 64, 128, 0), (128, 1)),           # one row, a ragged tile
    ((65, 192, 256, 0), (128, 2)),
    ((63, 128, 3072, 1), (128, 2)),        # 64 u columns a tile
    ((2400, 192, 1024, 1), (128, 57)),     # 192 u columns: 19 x 3
]


@pytest.mark.parametrize("shape,want", W8A8_PLANS)
def test_w8a8_gemm_plan(shape, want):
    assert F.gemm_plan(*shape) == want


def test_w8a8_gemm_plan_follows_the_card():
    """The grid is the card's SM count or the tile count; the wide tile is
    taken only while it still gives every SM a tile."""
    assert F.gemm_plan(2400, 3072, 1024, 0, sms=8) == (256, 8)
    assert F.gemm_plan(2400, 1024, 1024, 0, sms=64) == (256, 64)
    assert F.gemm_plan(2400, 1024, 1024, 0, sms=160) == (128, 152)


@pytest.mark.parametrize("m,n,k,mode,reason", [
    (64, 100, 256, 0, "N a multiple of 64"), (64, 32, 256, 0, "N a multiple of 64"),
    (64, 128, 200, 0, "K a multiple of 128"), (64, 128, 3200, 0, "<= 3072"),
    (0, 128, 256, 0, "no rows"), (64, 128, 256, 2, "mode"),
])
def test_w8a8_gemm_plan_refuses(m, n, k, mode, reason):
    with pytest.raises(ValueError, match=reason):
        F.gemm_plan(m, n, k, mode)


def test_w8a8_rows_of_the_decoder():
    """The decoder's x (2, 1200, 1024), one of its rows and one CFG row are
    contiguous rows."""
    x = torch.zeros((2, 1200, 1024), dtype=torch.bfloat16)
    assert F._rows(x, "x") == 2400
    assert F._rows(x[1], "x") == 1200
    assert F._rows(x[0, 0], "x") == 1
    # the last layer's slice, once made contiguous (the decoder adds to it first)
    assert F._rows(x[:, 450:] + 0, "x") == 1500


@pytest.mark.parametrize("make,reason", [
    (lambda: torch.zeros((2, 1200, 1024), dtype=torch.bfloat16)[:, 450:], "contiguous"),
    (lambda: torch.zeros((2, 40, 256), dtype=torch.bfloat16)[..., ::2], "contiguous"),
    (lambda: torch.zeros((2, 40, 132), dtype=torch.bfloat16)[..., :128], "contiguous"),
    (lambda: torch.zeros((3, 4, 128), dtype=torch.bfloat16).transpose(0, 1), "contiguous"),
    (lambda: torch.zeros(40 * 128 + 1, dtype=torch.bfloat16)[1:].view(40, 128),
     "16-byte boundary"),
    (lambda: torch.zeros((0, 128), dtype=torch.bfloat16), "no rows"),
])
def test_w8a8_rows_refuses(make, reason):
    with pytest.raises(ValueError, match=reason):
        F._rows(make(), "x")


@pytest.mark.parametrize("dtypes,bf16", [
    ((torch.bfloat16, torch.bfloat16, torch.bfloat16), True),    # the decoder's
    ((torch.float32, torch.float32, torch.float32), False),
    ((torch.bfloat16, torch.bfloat16, torch.float32), False),    # mixed: f32 copies
    ((torch.bfloat16, torch.bfloat16, None), True),              # no bias
    ((None, None, torch.float16), False),
])
def test_w8a8_vectors(dtypes, bf16):
    """The LN and bias vectors go to the kernels as they are when all are
    bf16 or all f32, else as f32 copies holding the same values."""
    vecs = [None if d is None else torch.linspace(-1, 1, 256).to(d) for d in dtypes]
    got, is_bf16 = F._vectors(*((v, 256, "v") for v in vecs))
    assert is_bf16 == bf16
    for v, g in zip(vecs, got):
        if v is None:
            assert g is None
            continue
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        assert torch.equal(g.float(), v.float())
        if v.dtype == g.dtype:
            assert g.data_ptr() == v.data_ptr()     # read where it lies, no copy


def test_w8a8_vectors_refuse_a_wrong_length():
    with pytest.raises(ValueError, match=r"bias must be \(64,\)"):
        F._vectors((torch.zeros(128), 128, "LN weight"), (torch.zeros(32), 64, "bias"))


def test_w8a8_refuses_activations_and_weights_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="bf16"):
        F._check_x(torch.zeros((4, 128)), "fused_linear")
    with pytest.raises(ValueError, match="unsupported device"):
        F.fused_linear(torch.zeros((4, 128), dtype=torch.bfloat16, device="meta"),
                       (torch.zeros((64, 128), dtype=torch.int8), torch.ones(64)))
    s = torch.ones(64)
    q = torch.zeros((128, 64), dtype=torch.int8).t()                 # not K-major rows
    with pytest.raises(ValueError, match="contiguous"):
        F._check_w((q, s), 128, "w")
    q = torch.zeros(64 * 128 + 1, dtype=torch.int8)[1:].view(64, 128)   # off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        F._check_w((q, s), 128, "w")
    with pytest.raises(ValueError, match="scales"):
        F._check_w((torch.zeros((64, 128), dtype=torch.int8), s.double()), 128, "w")



# ------------------------------------------------------------ K9's plan

# (B L rows, B Lk memory rows) -> each site's (tile_b, grid), in SITES order:
# the tile whose last wave on 132 SMs ends first (rounds x tile_b), a tie
# kept by the wider tile
MEGA_PLANS = [
    # the smoke request, 2 x 725 over 2 x 66: 12 row tiles; qkv 144 wide
    # tiles (2 rounds of 256) or 288 narrow (3 rounds of 128): narrow
    ((1450, 132), ((128, 132), (128, 96), (128, 96), (128, 32), (128, 96), (128, 132),
                   (128, 96))),
    # the bench geometry, 2 x 1200: qkv 228 wide tiles (2 rounds) tie 456
    # narrow (4 rounds); sa_out 76 wide (1 round) tie 152 narrow (2); WV 456
    # wide (4 rounds of 256) loses to 912 narrow (7 of 128)
    ((2400, 132), ((256, 132), (256, 76), (256, 76), (128, 32), (256, 76), (128, 132),
                   (256, 76))),
    # B L = 2 x 77, not a multiple of 128; Lk 9
    ((154, 18), ((128, 48), (128, 16), (128, 16), (128, 16), (128, 16), (128, 96),
                 (128, 16))),
]


@pytest.mark.parametrize("rows,want", MEGA_PLANS)
def test_mega_plan(rows, want):
    from mars5_tts_torch.ops.kernels import nar_mega as M

    assert M.mega_plan(M.MegaDims(16, 1024, 16, 3072), *rows) == want


def test_mega_site_shapes_and_plan_follow_the_dims():
    """Each site's (M, N, K, mode) at D 256 / F 768; the plan follows the card's
    SM count."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    d = M.MegaDims(2, 256, 4, 768)
    assert M.site_shapes(d, 200, 38) == (
        (200, 768, 256, 0), (200, 256, 256, 0), (200, 256, 256, 0), (38, 512, 256, 0),
        (200, 256, 256, 0), (200, 768, 256, 1), (200, 256, 768, 0))
    assert M.mega_plan(d, 200, 38) == ((128, 12), (128, 4), (128, 4), (128, 4), (128, 4),
                                       (128, 24), (128, 4))
    assert M.site_plan(2400, 3072, 1024, 0, sms=8) == (128, 8)       # 57 x 128 < 29 x 256
    assert M.site_plan(2400, 1024, 1024, 0, sms=160) == (128, 152)   # one round of the narrow
    assert M.site_plan(1450, 3072, 1024, 1, sms=132) == (128, 132)


def test_mega_scratch_and_launches():
    """The scratch the C entry takes (the int8 A operand sized for the wider
    of D and F) and the kernels a call launches (the memory quant, then 15 a
    layer)."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    d = M.MegaDims(16, 1024, 16, 3072)
    bf, s8, f32 = torch.bfloat16, torch.int8, torch.float32
    assert M.scratch_shapes(d, 2, 725, 66) == (
        ((1450, 3072), bf), ((1450, 1024), bf), ((1450, 1024), bf), ((132, 2048), bf),
        ((1450, 3072), bf), ((1450, 3072), s8), ((1450,), f32), ((132, 1024), s8),
        ((132,), f32))
    assert M.kernels_per_call(16) == 241 and M.kernels_per_call(1) == 16


@pytest.mark.parametrize("m,n,k,mode,reason", [
    (64, 100, 256, 0, "N a multiple of 64"), (64, 128, 200, 0, "K a multiple of 128"),
    (64, 128, 3200, 0, "<= 3072"), (0, 128, 256, 0, "no rows"), (64, 128, 256, 2, "mode"),
])
def test_mega_site_plan_refuses(m, n, k, mode, reason):
    from mars5_tts_torch.ops.kernels import nar_mega as M

    with pytest.raises(ValueError, match=reason):
        M.site_plan(m, n, k, mode)


def test_mega_refuses_devices_it_has_no_kernel_for():
    from mars5_tts_torch.ops.kernels import nar_mega as M

    d = M.MegaDims(1, 256, 4, 768)
    mp = M.MegaPack(d, torch.zeros((1, d.layer_bytes), dtype=torch.int8),
                    torch.ones((1, 9 * 256 + 2 * 768)), torch.zeros((1, 9 * 256)),
                    torch.zeros((1, 6 * 256)))
    x = torch.zeros((2, 10, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        M.mega_decoder_stack(mp, x, x[:, :3])


# ------------------------------------------------------------ K8's plan

def test_head4_slab_plan_at_the_head():
    """24,000 rows of 768 packed bytes on 132 SMs: 182 rows a block, the last
    slab ragged (158 rows); six stages of 32 rows hold a whole slab (147 KB),
    beside the int8 rows, their scales and amaxes and the barriers."""
    from mars5_tts_torch.ops.kernels import head4 as H

    for b in (1, 4, 8):
        rows, grid, stages, smem = H.slab_plan(24_000, 1536, b)
        assert (rows, grid, stages) == (182, 132, 6)
        assert 24_000 - (grid - 1) * rows == 158
        assert smem == 6 * 32 * 768 + b * 1536 + 64 + 16 * 6


@pytest.mark.parametrize("v,k,b,want", [
    (100_000, 1536, 4, (758, 132, 6)),       # 24 chunks a slab through a six-stage ring
    (500, 256, 3, (4, 125, 1)),              # one chunk a slab, one stage
    (24_000, 8192, 8, (182, 132, 1)),        # 128 KB stages: one fits the ring
    (131, 1536, 1, (1, 131, 1)),
])
def test_head4_slab_plan_geometries(v, k, b, want):
    """Every vocabulary row in exactly one slab, the last one ragged but not
    empty, and the shared memory within a block's 227 KB."""
    from mars5_tts_torch.ops.kernels import head4 as H

    rows, grid, stages, smem = H.slab_plan(v, k, b)
    assert (rows, grid, stages) == want
    assert grid * rows >= v > (grid - 1) * rows
    assert stages * H.STAGE_ROWS * (k // 2) <= H.RING_BYTES and smem <= 227 * 1024


def test_head4_refuses_devices_it_has_no_kernel_for():
    from mars5_tts_torch.ops.kernels import head4 as H

    wp = torch.zeros((64, 128), dtype=torch.int8, device="meta")
    ws = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA rows"):
        H.head4_logits(torch.zeros((1, 256), dtype=torch.bfloat16, device="meta"), wp, ws,
                       n_vocab=64)

# ------------------------------------------------------------ K6's plan

def test_heads_tail_plan_at_the_bench_shape():
    """32 frames a block, 17 tiles of 64 classes (the last holds class 1024
    and 63 padded ones), as many ring stages as let two blocks share an SM:
    the 24 x 7 grid is one wave on 132 SMs."""
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    plan = D.heads_tail_plan(1, 750, 7, 1025, 1024)
    assert plan.grid == (24, 7, 1) and plan.class_tiles == 17
    assert plan.stages == 5 and plan.smem_bytes <= D.SMEM_TWO_BLOCKS
    assert plan.smem_bytes >= 8 * 8192 + 5 * 8192 + 8 * 11 + 1024
    assert 24 * 7 <= 2 * 132


@pytest.mark.parametrize("bs,length,dim,stages", [(2, 33, 1024, 5), (1, 1, 128, 12),
                                                  (1, 750, 2048, 12)])
def test_heads_tail_plan_geometries(bs, length, dim, stages):
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    plan = D.heads_tail_plan(bs, length, 7, 1025, dim)
    assert plan.grid == (-(-length // 32), 7, bs) and plan.stages == stages
    assert plan.smem_bytes <= D.SMEM_LIMIT


@pytest.mark.parametrize("dim,classes,match", [(1000, 1025, "multiple of 128"),
                                               (1024, 2100, "K <= 2048"),
                                               (4096, 1025, "shared")])
def test_heads_tail_plan_refuses(dim, classes, match):
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    with pytest.raises(ValueError, match=match):
        D.heads_tail_plan(1, 10, 7, classes, dim)


def test_padded_classes_never_win():
    """The last weight tile's 63 padded classes are zero-filled weights: had
    their logits (0, no bias) entered the tail, they would beat classes whose
    logits are all far below 0 and take the argmax. Kept out by the mask,
    the tail over the tiles' classes picks the twin's indices."""
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.ops.kernels import diffusion_tail as D

    g = torch.Generator().manual_seed(0)
    mask = D.class_tile_mask(1025)
    assert mask.shape == (17 * 64,) and int(mask.sum()) == 1025 and bool(mask[:1025].all())
    n = mask.numel()
    logits = (torch.randn((2, 6, 7, 1025), generator=g) - 40.0).to(torch.bfloat16)
    u0 = torch.rand((1, 6, 7, n), generator=g)
    x_t = torch.randint(0, 1025, (1, 6, 7), generator=g)
    scal = D.tail_scalars(MultinomialDiffusion(1025, 200), 0)
    padded = torch.zeros((2, 6, 7, n), dtype=torch.bfloat16)
    padded[..., :1025] = logits
    unmasked = D.logit_scores(padded, u0, x_t, scal, w=3.0, temp=0.7).argmax(-1)
    assert bool((unmasked >= 1025).all())
    masked = D.logit_scores(padded[..., mask], u0[..., mask], x_t, scal, w=3.0,
                            temp=0.7).argmax(-1)
    want = D.diffusion_tail_ref(logits, u0[..., :1025].contiguous(), x_t, scal, w=3.0, temp=0.7)
    assert torch.equal(masked, want)


# ---------------------------------- K3/K4 groups, K1's int8 mode, NAR options

@pytest.mark.parametrize("k,groups,match", [
    (1024, 64, "multiple of 32"),       # 16-column groups: half an s8 wgmma step
    (1024, 3, "does not divide"), (3072, 5, "does not divide"), (1024, 0, "does not divide")])
def test_w8a8_group_sizes_refused(k, groups, match):
    with pytest.raises(ValueError, match=match):
        F._gsize(k, groups, "fused_linear")


@pytest.mark.parametrize("k,groups,gsize", [(1024, 1, 1024), (1024, 8, 128), (3072, 24, 128),
                                            (1024, 32, 32), (3072, 32, 96), (3072, 8, 384)])
def test_w8a8_group_sizes_taken(k, groups, gsize):
    assert F._gsize(k, groups, "fused_linear") == gsize


def test_w8a8_group_scales_of_the_wrong_shape_refused():
    q = torch.zeros((64, 256), dtype=torch.int8)
    for s, groups in ((torch.ones((4, 64)), 2), (torch.ones((2, 32)), 2),
                      (torch.ones((4, 64)), 1), (torch.ones((2, 64), dtype=torch.float64), 2)):
        with pytest.raises(ValueError, match="scales"):
            F._check_w((q, s), 256, "w", groups)
    assert F._check_w((q, torch.ones((2, 64))), 256, "w", 2)[2] is True
    _, s, grouped = F._check_w((q, torch.ones((1, 64))), 256, "w", 2)   # one group: per row
    assert s.shape == (64,) and grouped is False


def test_w8a8_gemm_plan_takes_the_narrow_tile_grouped():
    assert F.gemm_plan(2400, 3072, 1024, 0, 132) == (256, 132)
    # 456 tiles of 128 (4 rounds of 256 rows pulled a stage) end before 912
    # of 64 (7 rounds of 192)
    assert F.gemm_plan(2400, 3072, 1024, 0, 132, True) == (128, 132)
    assert F.gemm_plan(2400, 3072, 1024, 1, 132, True) == (128, 132)
    # 8 tiles of 128 rows by 128 take a round of 256 rows a stage, 16 of 64
    # one of 192: the narrow tile
    assert F.gemm_plan(128, 1024, 1024, 0, 132, True) == (64, 16)


def _last_wave_end(m, n, mode, bn, sms):
    """When the last wave of bn-row tiles ends, a tile's time taken as the
    rows its stages pull (128 of A and bn of weights), or None where mode
    1's bn / 2 u columns do not divide n; and the tile count."""
    cols = bn if mode == 0 else bn // 2
    if mode == 1 and n % cols:
        return None
    tiles = -(-m // F.TILE_M) * -(-n // cols)
    return -(-tiles // sms) * (F.TILE_M + bn), tiles


# (M, N, K, mode) of the decoder's grouped sites -> (tile_b, grid) on 132 SMs
W8A8_GROUPED_PLANS = [
    ((2400, 3072, 1024, 0), (128, 132)),   # qkv: 456 tiles of 128, 4 rounds (912 of 64: 7)
    ((2400, 1024, 1024, 0), (128, 132)),   # caq, sa_out: 152 of 128, 2 (304 of 64: 3)
    ((2400, 3072, 1024, 1), (128, 132)),   # WV: 912 of 128, 7 (1,824 of 64: 14)
    ((2400, 1024, 3072, 0), (128, 132)),   # lin2, as caq
    ((1450, 3072, 1024, 0), (128, 132)),   # the smoke request's 725 frames: 288 of 128, 3 (5)
    ((1450, 1024, 1024, 0), (128, 96)),    # 96 of 128 in one round (192 of 64: 2)
    ((1450, 3072, 1024, 1), (128, 132)),   # 576 of 128, 5 (1,152 of 64: 9)
    ((1450, 1024, 3072, 0), (128, 96)),
    ((256, 1024, 1024, 0), (64, 32)),      # 16 of 128 or 32 of 64, one round each
    ((200, 384, 256, 1), (64, 24)),
]


@pytest.mark.parametrize("shape,want", W8A8_GROUPED_PLANS)
def test_w8a8_grouped_plan_by_the_wave_tail(shape, want):
    """The grouped plan takes the tile whose last wave ends first, by K9's
    ``site_plan`` rule, a tile's time taken as the rows its stages pull
    (the grouped GEMMs run at the rate L2 feeds their rings), a tie keeping
    the wider tile."""
    from mars5_tts_torch.ops.kernels import nar_mega as M

    m, n, k, mode = shape
    assert F.gemm_plan(*shape, 132, True) == want
    ends = {bn: _last_wave_end(m, n, mode, bn, 132) for bn in F.TILE_B_GROUPED}
    best = min((e[0], -bn) for bn, e in ends.items() if e is not None)
    assert want == (-best[1], min(ends[-best[1]][1], 132))
    assert F.wave_plan(*shape, F.TILE_B_GROUPED, 132, F.TILE_M) == want
    assert F.wave_plan(*shape, F.TILE_B, 132) == M.site_plan(*shape)


@pytest.mark.parametrize("m,pitch", [(1, 4), (3, 4), (4, 4), (63, 64), (1450, 1452),
                                     (2400, 2400), (2401, 2404)])
def test_grouped_scales_pitch(m, pitch):
    """The grouped kernels' activation scales are (G, pitch) in the scratch,
    each group's row on a 16-byte boundary, as the GEMM's bulk copies need
    (the C entries refuse a pitch below M or not a multiple of 4)."""
    assert F.xs_pitch(m) == pitch and pitch % 4 == 0 and m <= pitch < m + 4


def test_mha_int8_mode_refuses_head_dims_and_devices():
    q, k, v = _qkv_views(2, 40, 2)
    with pytest.raises(ValueError, match="head_dim"):
        K.launch_args(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="unsupported device"):
        K.mha(*(torch.zeros((1, 4, 1, 64), device="meta") for _ in range(3)), quantized=True)


@pytest.mark.parametrize("shape,grids,lkp,scratch", [
    # (B, Lq, Lk, H): the bench's self-attention, the smoke request's, its
    # cross-attention over 66 memory tokens, a tiny ragged one
    ((2, 1200, 1200, 16), ((19, 32), (19, 32), (32, 7)), 1216,
     32 * 1200 * 64 + 32 * 64 * 1216 + 32 * 1200 * 4 + 32 * 64 * 4 + 32 * 19 * 64 * 4),
    ((2, 725, 725, 16), ((12, 32), (12, 32), (32, 4)), 736,
     32 * 725 * 64 + 32 * 64 * 736 + 32 * 725 * 4 + 32 * 64 * 4 + 32 * 12 * 64 * 4),
    ((2, 725, 66, 16), ((2, 32), (2, 32), (32, 4)), 96,
     32 * 66 * 64 + 32 * 64 * 96 + 32 * 66 * 4 + 32 * 64 * 4 + 32 * 2 * 64 * 4),
    ((1, 1, 1, 1), ((1, 1), (1, 1), (1, 1)), 32, 128 + 64 * 32 + 128 + 64 * 4 + 64 * 4),
])
def test_mha_int8_plan(shape, grids, lkp, scratch):
    """The int8 mode's three launches and scratch: grids (the attention's
    (B H, 192-query tiles)), v8t's keys padded to 32, each part on a
    128-byte boundary in order, and the TMA maps' geometry over them."""
    b, lq, lk, h = shape
    plan = K.int8_plan(b, lq, lk, h)
    assert plan.grids == grids and plan.lkp == lkp and plan.n_kb == -(-lk // 64)
    assert plan.scratch_bytes == scratch
    end = 0
    for name, (off, shp, dt) in plan.parts.items():
        assert off % 128 == 0 and off >= end
        end = off + torch.Size(shp).numel() * dt.itemsize
    assert end <= plan.scratch_bytes < end + 128
    bh = b * h
    assert plan.parts["k8"][1] == (bh, lk, 64) and plan.parts["v8t"][1] == (bh, 64, lkp)
    assert plan.maps["k8"] == ((64, lk, bh), (64, 64 * lk), (64, 128, 1), 64)
    assert plan.maps["v8t"] == ((lkp, 64, bh), (lkp, 64 * lkp), (128, 64, 1), 128)
    for dims, strides, box, swizzle in plan.maps.values():
        # TMA: strides multiples of 16 bytes, a box row of the swizzle's width
        assert all(st % 16 == 0 for st in strides) and box[0] == swizzle


@pytest.mark.parametrize("change,match", [
    ("f32", "bf16"), ("head_dim", "head_dim"), ("offset", "16-byte boundary"),
    ("stride", "16 bytes")])
def test_mha_int8_launch_args_refuse(change, match):
    q, k, v = _qkv_views(2, 40, 2)
    if change == "f32":
        q, k, v = q.float(), k.float(), v.float()
    elif change == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif change == "offset":
        q = torch.zeros((2, 40, 2 * 64 + 8), dtype=torch.bfloat16)[..., 1:129].reshape(2, 40, 2, 64)
    else:
        q = torch.zeros((2, 40, 2, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match=match):
        K.int8_launch_args(q, k, v)
    assert K.int8_launch_args(*_qkv_views(2, 40, 2)) == K.launch_args(*_qkv_views(2, 40, 2))


def _mega_geometry_nar(gsize):
    """A NAR whose decoder K9 takes (2 heads of 64, D 128, F 256), quantized
    per row or with group scales."""
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.quant import nar_w_group_keys, quantize_nar

    cfg = ResidualTransformerConfig(259, dim=128, nhead=2, enc_layers=1, dec_layers=1,
                                    n_spk_layers=1, t_emb_dim=64, hidden_dim=256)
    nar = ResidualTransformer(cfg).init_(torch.Generator().manual_seed(0)).eval()
    return nar, quantize_nar(nar, w_gsize=gsize,
                             w_group_keys=nar_w_group_keys(("qkv", "caq", "ffn")))


def test_mega_refuses_grouped_weights():
    from mars5_tts_torch.ops.kernels.nar_mega import build_mega_pack, mega_supported

    _, per_row = _mega_geometry_nar(0)
    _, grouped = _mega_geometry_nar(64)
    assert mega_supported(per_row.tfm.decoder)
    assert not mega_supported(grouped.tfm.decoder)
    with pytest.raises(ValueError, match="per-row"):
        build_mega_pack(grouped.tfm.decoder)


@pytest.mark.parametrize("kw,backend,match", [
    (dict(nar_sites=("qkv", "attn")), "int8", "unknown NAR sites"),
    (dict(nar_gsize=64, nar_mega=True), "int8", "nar_mega"),
    (dict(nar_sites=("qkv", "saout", "caq", "ffn"), nar_mega=True), "int8", "nar_mega"),
    (dict(nar_gsize=64, nar_fused=False), "int8", "nar_fused=True"),
    (dict(nar_gsize=-32), "int8", "gsize"),
    (dict(nar_fused=False), "bf16", "nar_backend='int8'"),
    (dict(nar_qattn=True), "bf16", "nar_backend='int8'"),
    (dict(nar_gsize=64), "bf16", "nar_backend='int8'"),
    (dict(nar_sites=("qkv",)), "bf16", "nar_backend='int8'")])
def test_pipeline_refuses_nar_options(kw, backend, match):
    """``Mars5TTS``'s NAR options: an unknown site, a grouped or site-set NAR
    with K9, group scales off the fused route, the int8-only options on the
    bf16 NAR; ``nar_cross_k1`` is taken by both NARs, and a per-row int8
    NAR cannot be taken as a grouped one."""
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.register_special_tokens({"<|startoftext|>": 256, "<|endoftext|>": 257})
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN, codebook_size=1024)
    speechtok.register_special_tokens({"<|endofspeech|>": 1024})
    ar = CodecLM(CodecLMConfig.tiny(1283)).init_(torch.Generator().manual_seed(1)).eval()
    nar, per_row = _mega_geometry_nar(0)
    common = dict(texttok=texttok, speechtok=speechtok)
    with pytest.raises(ValueError, match=match):
        Mars5TTS.from_params(ar, nar, nar_backend=backend, **kw, **common)
    for b in ("bf16", "int8"):
        tts = Mars5TTS.from_params(ar, nar, nar_backend=b, nar_cross_k1=True, **common)
        assert tts.nar_options.cross_k1 and tts.nar_options.sites == ("qkv", "caq", "ffn")
    with pytest.raises(ValueError, match="already quantized"):
        Mars5TTS.from_params(ar, per_row, nar_backend="int8", nar_gsize=64, **common)
