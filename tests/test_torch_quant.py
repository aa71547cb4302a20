"""W8A8 quantization of the port (``ops/quant.py``, the folded heads and the
quantized state dicts) against the JAX package's ``ops/quant.py``.

Quantized tensors are bit-identical (same f32 ops, half-to-even rounding,
true division); the folded heads' int8 weights and scales are bit-identical
and their bias agrees to 1e-6 relative (an einsum, whose f32 sum order
differs between the frameworks).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import port_config, tiny_models  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,scale", [((64, 48), 0.05), ((3, 40, 96), 1.0),
                                         ((17, 8), 1e-6)])
def test_quantize_weight_and_act_bit_identical(shape, scale):
    from mars5_tts_tpu.ops import quant as J
    from mars5_tts_torch.ops import quant as P

    r = np.random.default_rng(len(shape) + shape[-1])
    w = (r.standard_normal(shape) * scale).astype(np.float32)
    w[..., 0, :3] = 0.5 * scale          # ties at the rounding boundary are rare; add
    qj, sj = J.quantize_weight(jnp.asarray(w), axis=-1)
    qp, sp = P.quantize_weight(t(w))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    for x in (w, w.astype(jnp.bfloat16).astype(np.float32)):
        xj, xsj = J.quantize_act(jnp.asarray(x))
        xp, xsp = P.quantize_act(t(x))
        np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(xsp.numpy(), np.asarray(xsj))


def test_round_half_to_even_and_int8_matmul_exact():
    from mars5_tts_torch.ops import quant as P

    # 2.5 / 1 -> 2, 3.5 -> 4, -2.5 -> -2: jnp.round rounds half to even
    q, _ = P.quantize_act(torch.tensor([[127.0, 2.5, 3.5, -2.5]]))
    assert q.tolist() == [[127, 2, 4, -2]]
    r = np.random.default_rng(3)
    a = t(r.integers(-127, 128, (2, 5, 96)).astype(np.int8))
    b = t(r.integers(-127, 128, (33, 96)).astype(np.int8))
    got = P.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long().t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_w8a8_matches_jax(dtype):
    from mars5_tts_tpu.ops import quant as J
    from mars5_tts_torch.ops import quant as P

    r = np.random.default_rng(4)
    x = r.standard_normal((2, 7, 64)).astype(np.float32)
    w = (r.standard_normal((48, 64)) * 0.1).astype(np.float32)
    b = (r.standard_normal(48) * 0.1).astype(np.float32)
    q, s = J.quantize_weight(jnp.asarray(w), axis=-1)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = J.linear_w8a8(jnp.asarray(x).astype(jd), q, s, jnp.asarray(b).astype(jd))
    got = P.linear_w8a8(t(x).to(dtype), t(q), t(s), t(b).to(dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _jax_nar_with_affines(seed=0):
    """Tiny JAX NAR with head LN affines and biases moved away from 1 / 0 (at
    init folding would be a no-op), as the JAX package's own tests do."""
    cfgs, params = tiny_models(seed)
    p = jax.tree.map(jnp.asarray, params["nar"])
    k = jax.random.PRNGKey(5)
    rd = dict(p["residual_decoder"])
    rd["ln_w"] = jax.random.uniform(k, rd["ln_w"].shape, jnp.float32, 0.3, 1.8)
    rd["ln_b"] = jax.random.normal(jax.random.fold_in(k, 1), rd["ln_b"].shape) * 0.2
    rd["lin_b"] = jax.random.normal(jax.random.fold_in(k, 2), rd["lin_b"].shape) * 0.1
    p["residual_decoder"] = rd
    return cfgs["nar"], p


def _port(jcfg, p):
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfg = port_config(jcfg, ResidualTransformerConfig)
    return load_nar(nar_reference_state_dict(jax.tree.map(np.asarray, p), cfg), cfg)


def test_quantize_nar_bit_identical_and_converter_loads_jax_int8():
    """The port's quantize_nar of the converted model equals, weight by weight,
    the JAX package's quantize_nar carried across by the converter; the
    speaker encoder stays unquantized and the bf16 model is left intact."""
    from mars5_tts_tpu.ops.quant import quantize_nar as j_quantize
    from mars5_tts_torch.ops.quant import QuantWeight, nar_quant_sites, quantize_nar

    jcfg, p = _jax_nar_with_affines()
    dense = _port(jcfg, p)
    before = {k: v.clone() for k, v in dense.state_dict().items()}
    mine = quantize_nar(dense)
    carried = _port(jcfg, j_quantize(p))
    assert mine.is_quantized and carried.is_quantized and not dense.is_quantized
    sd_m, sd_c = mine.state_dict(), carried.state_dict()
    assert sd_m.keys() == sd_c.keys()
    for k in sd_m:
        assert sd_m[k].dtype == sd_c[k].dtype, k
        assert torch.equal(sd_m[k], sd_c[k]), k
    n_sites = sum(1 for _ in nar_quant_sites(mine))
    assert n_sites == 5 * jcfg.enc_layers + 7 * jcfg.dec_layers + 8
    assert sum(isinstance(m, QuantWeight) for m in mine.modules()) == n_sites
    assert not any(isinstance(m, QuantWeight) for m in mine.spk_encoder.modules())
    assert all(torch.equal(v, dense.state_dict()[k]) for k, v in before.items())
    # idempotent, and the scales stay f32 through a cast
    again = quantize_nar(mine.to(torch.bfloat16))
    assert torch.equal(again.tfm.decoder.layers[0].linear2.weight.q,
                       mine.tfm.decoder.layers[0].linear2.weight.q)
    assert again.tfm.decoder.layers[0].linear2.weight.s.dtype == torch.float32
    assert again.tfm.decoder.layers[0].norm1.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("lanes", [tuple(range(1, 8)), (0, 3, 5)])
def test_fold_quant_heads_matches_jax(lanes):
    from mars5_tts_tpu.models.nar import fold_quant_heads as j_fold
    from mars5_tts_tpu.ops.quant import quantize_nar as j_quantize
    from mars5_tts_torch.models.nar import fold_quant_heads

    jcfg, p = _jax_nar_with_affines()
    pq = j_quantize(p)
    ref = j_fold(pq, jcfg, lanes)
    got = fold_quant_heads(_port(jcfg, pq), lanes)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(ref["b"]), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref["b"])).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_heads_prequant_and_folded_match_jax(dtype):
    """bf16: ``nar_heads_prequant`` and ``nar_heads_folded`` bit-identical (the
    normalised rows are rounded to bf16 before the quant). f32: the int8 rows
    identical, the row scales and logits within 1e-6 relative (the f32 sum
    order of the LN statistics differs between the frameworks)."""
    from mars5_tts_tpu.models.nar import fold_quant_heads as j_fold
    from mars5_tts_tpu.models.nar import nar_heads_folded as j_heads
    from mars5_tts_tpu.models.nar import nar_heads_prequant as j_pre
    from mars5_tts_tpu.ops.quant import quantize_nar as j_quantize
    from mars5_tts_torch.models.nar import nar_heads_folded, nar_heads_prequant

    jcfg, p = _jax_nar_with_affines()
    ref_fold = j_fold(j_quantize(p), jcfg, tuple(range(1, 8)))
    fold = {k: t(np.asarray(v)) for k, v in ref_fold.items()}
    out = np.random.default_rng(6).standard_normal((2, 9, jcfg.dim)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jo, to = jnp.asarray(out).astype(jd), t(out).to(td)
    x8_j, xs_j = j_pre(jo)
    x8_p, xs_p = nar_heads_prequant(to)
    ref = np.asarray(j_heads(ref_fold, jo).astype(jnp.float32))
    got = nar_heads_folded(fold, to).float().numpy()
    assert got.shape == ref.shape == (2, 9, 7, 1025)
    np.testing.assert_array_equal(x8_p.numpy(), np.asarray(x8_j))
    if dtype == "bf16":
        np.testing.assert_array_equal(xs_p.numpy(), np.asarray(xs_j))
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_j), rtol=1e-6, atol=0)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
