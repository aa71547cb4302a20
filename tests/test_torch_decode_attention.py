"""Kernel K7's plain twin (``mars5_tts_torch/ops/kernels/decode_attention``)
against the JAX package's decode attention: the Pallas kernel
``decode_attention_pallas`` in interpret mode and the XLA
``models/ar_decode._decode_attention`` the JAX engines run.

f32 inputs at the JAX kernel tests' geometry (``tests/test_pallas.py``: two
rows at different positions below, at and past the 64-slot window) agree
within their 2e-5; bf16 inputs within one bf16 ulp (the twin sums in f64, XLA
in f32). Poisoned invalid slots leave the output unchanged, and on the CPU
the wrapper takes the twin without building or counting a launch.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5            # tests/test_pallas.py
B, W, H, D = 2, 64, 4, 32


def _inputs(pos_val, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(dtype) for s in
               ((B, H, D), (B, W, H, D), (B, W, H, D)))
    kn, vn = (rng.standard_normal((B, H, D)).astype(dtype) for _ in range(2))
    return q, k, v, kn, vn, np.array([pos_val, max(pos_val - 3, 0)], np.int32)


@pytest.mark.parametrize("self_column", [False, True])
@pytest.mark.parametrize("pos_val", [5, 63, 100])       # below, at and past the window
def test_twin_matches_pallas_kernel_and_xla(pos_val, self_column):
    from mars5_tts_tpu.models.ar_decode import _decode_attention
    from mars5_tts_tpu.ops.pallas import decode_attention_pallas
    from mars5_tts_torch.ops.kernels.decode_attention import decode_attention

    q, k, v, kn, vn, pos = _inputs(pos_val, pos_val)
    new = (kn, vn) if self_column else ()
    jnew = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if self_column else {}
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), interpret=True, **jnew)
    xla = _decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), W, **jnew)
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pos),
                           *(torch.from_numpy(a) for a in new))
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pos_val", [5, 100])
def test_bf16_twin_within_one_ulp_of_xla(pos_val):
    """The bf16 AR engine's function: ring probabilities rounded to bf16
    before PV, the self column in f32; f64 against XLA's f32 sums."""
    from mars5_tts_tpu.models.ar_decode import _decode_attention
    from mars5_tts_torch.ops.kernels.decode_attention import decode_attention_ref, one_ulp

    q, k, v, kn, vn, pos = _inputs(pos_val, 7 + pos_val)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, kn, vn)]
    want = np.asarray(_decode_attention(*bf[:3], jnp.asarray(pos), W, k_new=bf[3],
                                        v_new=bf[4]).astype(jnp.float32))
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in bf]
    got = decode_attention_ref(*tb[:3], torch.from_numpy(pos), *tb[3:])
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(want).bfloat16()
    assert ((got.float() - want_t.float()).abs() <= one_ulp(got, want_t)).all()
    assert (got.float() == want_t.float()).float().mean() > 0.95


@pytest.mark.parametrize("self_column", [False, True])
def test_poisoned_invalid_slots_do_not_reach_the_output(self_column):
    """pos < W: the slots past pos (and, with the self column, the current
    token's stale slot) must not contribute (tests/test_pallas.py:29-48)."""
    from mars5_tts_torch.ops.kernels.decode_attention import decode_attention_ref, ring_valid

    q, k, v, kn, vn, pos = (torch.from_numpy(a) for a in _inputs(4, 1))
    new = (kn, vn) if self_column else ()
    out1 = decode_attention_ref(q, k, v, pos, *new)
    valid = ring_valid(pos, W, self_column)
    assert valid.sum(-1).tolist() == [5 - self_column, 2 - self_column]
    k2, v2 = k.clone(), v.clone()
    k2[~valid] = 1e3
    v2[~valid] = -1e3
    torch.testing.assert_close(decode_attention_ref(q, k2, v2, pos, *new), out1,
                               rtol=0, atol=1e-6)


def test_cpu_wrapper_takes_the_twin_and_counts_no_launch():
    from mars5_tts_torch.ops.kernels import build, decode_attention as A

    q, k, v, kn, vn, pos = (torch.from_numpy(a) for a in _inputs(63, 2))
    n0 = A.launch_count
    assert torch.equal(A.decode_attention(q, k, v, pos, kn, vn),
                       A.decode_attention_ref(q, k, v, pos, kn, vn))
    assert torch.equal(A.decode_attention(q, k, v, 70), A.decode_attention_ref(q, k, v, [70, 70]))
    assert A.launch_count == n0 and "decode_attention" not in build._loaded
    assert "decode_attention.cu" in build.LIBRARIES["decode_attention"]
