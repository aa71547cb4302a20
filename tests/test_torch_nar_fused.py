"""The plain twins of kernels K3 ``fused_linear`` and K4 ``fused_ffn``, and
the port's W8A8 decoder layer, against the JAX package's Pallas kernels run
in interpret mode (``ops/pallas/nar_fused.py``, ``decoder_layer_fused``).

Tolerance, the JAX kernel tests' own ``_assert_fused_eq``
(tests/test_nar_fused.py): |diff| <= 0.02 x max(peak, 1), the mean |diff|
below 2e-3 x max(peak, 1), and more than 95% of the elements exactly equal
(40% for the FFN's two chained quant GEMMs). The int32 GEMMs are exact; the
rest differs only where the f32 sum order of the LN statistics, or the
sigmoid's exp, flips a borderline rounding.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

D, F, LK = 256, 384, 32


def t(a):
    return torch.from_numpy(np.array(a))


def _assert_fused_eq(got, want, exact_frac=0.95):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(np.abs(w).max(), 1.0)
    np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * scale)
    assert (g == w).mean() > exact_frac
    assert np.abs(g - w).mean() < 2e-3 * scale


def _qd(w):
    from mars5_tts_tpu.ops.quant import quantize_weight
    q, s = quantize_weight(jnp.asarray(w), axis=-1)
    return {"q": q, "s": s, "a8": jnp.zeros(q.shape[:-2] if q.ndim > 2 else ())}


def _pair(w):
    """JAX quant dict -> the port's (q (N, K), s (N,)) pair."""
    return t(w["q"]).reshape(-1, w["q"].shape[-1]), t(w["s"]).reshape(-1)


def _bf16(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()


@pytest.fixture(scope="module")
def layer():
    """W8A8 weights and bf16 activations at the JAX test's geometry."""
    rng = np.random.default_rng(7)
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.05)
    p = {"norm1_w": mk(D) + 1, "norm1_b": mk(D), "norm3_w": mk(D) + 1, "norm3_b": mk(D),
         "sa_in_w": _qd(rng.standard_normal((3, D, D)) * 0.05), "sa_in_b": mk(3, D),
         "sa_out_w": _qd(rng.standard_normal((D, D)) * 0.05), "sa_out_b": mk(D),
         "WV": _qd(rng.standard_normal((2 * F, D)) * 0.05),
         "lin2_w": _qd(rng.standard_normal((D, F)) * 0.05), "lin2_b": mk(D)}
    x = jnp.asarray(rng.standard_normal((2, 96, D)).astype(np.float32), jnp.bfloat16)
    return p, x


@pytest.mark.parametrize("variant", ["ln_bias", "residual", "crossq"])
def test_fused_linear_ref_matches_pallas(layer, variant):
    from mars5_tts_tpu.ops.pallas.nar_fused import fused_linear
    from mars5_tts_tpu.ops.quant import slice_rows
    from mars5_tts_torch.ops.kernels.nar_fused import fused_linear_ref

    p, x = layer
    ln = (p["norm1_w"], p["norm1_b"])
    tln = (t(ln[0]), t(ln[1]))
    if variant == "ln_bias":
        want = fused_linear(x, p["sa_in_w"], ln=ln, bias=p["sa_in_b"], bm=64, interpret=True)
        got = fused_linear_ref(_bf16(x), _pair(p["sa_in_w"]), ln=tln,
                               bias=t(p["sa_in_b"]).reshape(-1))
    elif variant == "residual":
        a = (x * jnp.bfloat16(0.5))
        want = fused_linear(a, p["sa_out_w"], bias=p["sa_out_b"], residual=x, bm=64,
                            interpret=True)
        got = fused_linear_ref(_bf16(a), _pair(p["sa_out_w"]), bias=t(p["sa_out_b"]),
                               residual=_bf16(x))
    else:   # the q third of a stacked in-projection, as the caq site takes it
        w = slice_rows(p["sa_in_w"], slice(0, 1))
        want = fused_linear(x, w, ln=ln, bias=p["sa_in_b"][:1], bm=64, interpret=True)
        q, s = _pair(p["sa_in_w"])
        got = fused_linear_ref(_bf16(x), (q[:D], s[:D]), ln=tln, bias=t(p["sa_in_b"][0]))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_fused_eq(got.float().numpy(), want.astype(jnp.float32))


def test_fused_ffn_ref_matches_pallas(layer):
    from mars5_tts_tpu.ops.pallas.nar_fused import fused_ffn
    from mars5_tts_torch.ops.kernels.nar_fused import fused_ffn_ref

    p, x = layer
    want = fused_ffn(x, p["norm3_w"], p["norm3_b"], p["WV"], p["lin2_w"], p["lin2_b"],
                     bm=64, interpret=True)
    q, s = _pair(p["WV"])
    got = fused_ffn_ref(_bf16(x), (t(p["norm3_w"]), t(p["norm3_b"])), (q[:F], s[:F]),
                        (q[F:], s[F:]), _pair(p["lin2_w"]), t(p["lin2_b"]))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_fused_eq(got.float().numpy(), want.astype(jnp.float32), exact_frac=0.4)


@pytest.fixture(scope="module")
def nar_pair():
    """A JAX NAR at d = 256 (4 heads of 64, FFN 384, 2 decoder layers) with
    the decoder's LN affines and biases moved off 1 / 0, quantized by the JAX
    package and carried into the port by the converter."""
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig as PCfg
    from tests.torch_port_fixtures import port_config

    cfg = ResidualTransformerConfig(n_text_vocab=32, dim=D, nhead=4, enc_layers=1,
                                    dec_layers=2, n_spk_layers=1, t_emb_dim=64, hidden_dim=F)
    p = jax.tree.map(np.asarray, init_nar(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(8)
    lay = p["decoder"]["layers"]
    for k in list(lay):
        if k.startswith("norm") or k.endswith("_b"):
            base = 1.0 if k.endswith("_w") else 0.0
            lay[k] = (base + 0.05 * rng.standard_normal(lay[k].shape)).astype(np.float32)
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, p)))
    pcfg = port_config(cfg, PCfg)
    return cfg, pq, load_nar(nar_reference_state_dict(pq, pcfg), pcfg)


@pytest.mark.parametrize("dtype,q_start", [("bf16", 0), ("bf16", 40), ("f32", 40)])
def test_w8a8_decoder_layer_matches_decoder_layer_fused(nar_pair, dtype, q_start):
    """``DecoderLayer.forward_w8a8`` (with and without the final-layer query
    slice) against ``decoder_layer_fused(interpret=True)``, the same weights;
    key-padding masks on both attentions. The layer adds the attention twins'
    own difference (K1's ``mha_ref`` against the Pallas flash kernel, within 2
    bf16 ulp of each row's peak) to the GEMM sites', so the exactly-equal
    share is held at 40% in bf16. In f32 the attention outputs differ by a
    few f32 ulp nearly everywhere, which the layer's bf16 round trips (LN,
    silu) turn into bf16-ulp steps: f32 keeps the max and mean bounds and no
    exactly-equal share."""
    import copy

    from mars5_tts_tpu.models.layers import decoder_layer_fused

    cfg, pq, port = nar_pair
    i = 1 if q_start else 0
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    lp = jax.tree.map(lambda a: jnp.asarray(a[i]), pq["decoder"]["layers"])
    lp = jax.tree.map(lambda a: a.astype(jd) if a.dtype == jnp.float32 else a, lp)
    for k in ("sa_in_w", "sa_out_w", "ca_in_w", "ca_out_w", "WV", "lin2_w"):
        lp[k]["s"] = lp[k]["s"].astype(jnp.float32)
    rng = np.random.default_rng(9 + q_start)
    x = rng.standard_normal((2, 96, D)).astype(np.float32)
    mem = rng.standard_normal((2, LK, D)).astype(np.float32)
    kpm = np.zeros((2, 96), bool)
    kpm[1, 90:] = True
    mpm = np.zeros((2, LK), bool)
    mpm[0, 25:] = True
    want = decoder_layer_fused(lp, jnp.asarray(x).astype(jd), jnp.asarray(mem).astype(jd),
                               cfg.nhead, jnp.asarray(kpm), jnp.asarray(mpm),
                               interpret=True, q_start=q_start)
    layer = copy.deepcopy(port.tfm.decoder.layers[i]).to(td)
    assert layer.is_quantized
    got = layer.forward_w8a8(t(x).to(td), t(mem).to(td), t(kpm), t(mpm), q_start=q_start)
    assert got.dtype == td and got.shape == want.shape == (2, 96 - q_start, D)
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    _assert_fused_eq(g, w, exact_frac=0.4 if dtype == "bf16" else 0.0)


def test_decoder_stack_slices_the_last_layer(nar_pair):
    """With ``q_tail_start`` a W8A8 stack runs its last layer on the kept rows
    only; the kept rows equal the full computation's at the GEMM sites and
    agree to 1e-5 of the peak (f32) elsewhere."""
    _, _, port = nar_pair
    rng = np.random.default_rng(10)
    x = t(rng.standard_normal((2, 70, D)).astype(np.float32))
    mem = t(rng.standard_normal((2, LK, D)).astype(np.float32))
    dec = port.tfm.decoder
    sliced = dec(x, mem, q_tail_start=30)
    full = dec.norm(dec.layers[1](dec.layers[0](x, mem), mem))[:, 30:]
    assert sliced.shape == (2, 40, D)
    np.testing.assert_allclose(sliced.numpy(), full.numpy(), rtol=0,
                               atol=1e-5 * full.abs().max().item())


@pytest.mark.parametrize("with_ln,k", [(True, 1024), (False, 1024), (False, 3072), (True, 256)])
def test_prologue_ref_matches_jax_ln_and_quant_rows(with_ln, k):
    """The plain form of the kernels' per-row prologue (``prologue_ref``:
    [LN ->] int8 rows + f32 row scales) against the JAX package's
    ``_ln_bf16_f32`` and ``_quant_rows`` on seeded bf16 rows. Tolerance: the
    scales within 1 f32 ulp, since JAX sums the LN statistics in f32 (and
    takes ``rsqrt``) where the port sums in f64 and divides (ROADMAP C); the
    int8 codes equal in every row whose scale is equal, except within one
    code where such an LN rounding moved an element's bf16 value."""
    from mars5_tts_tpu.ops.pallas.nar_fused import _ln_bf16_f32, _quant_rows
    from mars5_tts_torch.ops.kernels.nar_fused import prologue_ref

    rng = np.random.default_rng(k + with_ln)
    x = jnp.asarray(rng.standard_normal((300, k)).astype(np.float32) * 2, jnp.bfloat16)
    xf = x.astype(jnp.float32)
    ln = None
    if with_ln:
        ln = (jnp.asarray(1 + 0.1 * rng.standard_normal(k).astype(np.float32)),
              jnp.asarray(0.1 * rng.standard_normal(k).astype(np.float32)))
        xf = _ln_bf16_f32(xf, ln[0], ln[1], 4e-5)
    want_q, want_s = (np.asarray(a) for a in _quant_rows(xf))
    got_q, got_s = prologue_ref(_bf16(x), None if ln is None else (t(ln[0]), t(ln[1])))
    got_q, got_s = got_q.numpy(), got_s.numpy()
    assert got_q.dtype == np.int8 and got_q.shape == (300, k) and got_s.shape == (300,)
    want_s = want_s[:, 0]
    ulp = np.spacing(np.abs(want_s))
    assert (np.abs(got_s - want_s) <= ulp).all()
    same = got_s == want_s
    assert same.mean() > 0.9
    d = np.abs(got_q[same].astype(np.int32) - want_q[same])
    if with_ln:
        assert d.max() <= 1 and (d == 0).mean() > 0.999
    else:    # no LN: the rows are the same bf16 values, so every row is exact
        assert same.all() and d.max() == 0
