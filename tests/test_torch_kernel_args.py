"""What the attention kernels' wrappers decide on the host, checked without a
card: K1's tensor-map eligibility of a view (``mha.tensor_map_strides``) and
its launch arguments, K7's cluster size for a slot count and its launch
arguments, and the refusals of both wrappers on inputs a CPU can build.
"""

import pytest
import torch

from mars5_tts_torch.ops.kernels import decode_attention as A
from mars5_tts_torch.ops.kernels import mha as K


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
