"""The W8A8 NAR's remaining modes in the port against the JAX package:
per-K-group scales (``quantize_weight_grouped``, ``quantize_nar(w_gsize=)``,
the grouped K3/K4 twins, JAX ``MARS5_NARF_GSIZE``), the fused layer's site
sets (``MARS5_NARF_SITES``), the unfused W8A8 layer (``MARS5_NAR_FUSED=0``)
and K1's int8 mode and cross-attention route (``MARS5_QATTN``,
``MARS5_CROSS_PALLAS``).

Tolerances: the quantizers bitwise; the grouped GEMM parts bitwise on the
same f32 inputs; whole K3/K4 outputs and decoder layers the JAX kernel
tests' ``_assert_fused_eq`` (as ``tests/test_torch_nar_fused.py``); the int8
attention twin against the Pallas kernel in interpret mode within the JAX
test's own mirror bound (``atol=2e-5, rtol=1e-4`` in f32,
``tests/test_pallas.py``); whole-NAR trajectories under injected uniforms
within the W8A8 limit of ROADMAP C (at most 4% of the grid cells).

On the CPU the JAX ``torch_mha`` never reaches its Pallas kernel; the
routes through it are driven here by patching, in the tests only, its
``ops.pallas.enabled`` (and the port's ``ops.attention.kernel_route``), its
``sdpa_pallas`` into interpret mode, its ``_QATTN`` / ``_CROSS_PALLAS`` and,
in both packages, the 512-query threshold, lowered to the tiny geometry.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import port_config, tiny_models  # noqa: E402

D, F, H, L, LK = 128, 384, 2, 40, 13
SITE_KEYS = {"qkv": ("sa_in_w",), "saout": ("sa_out_w",), "caout": ("ca_out_w",),
             "ffn": ("WV", "lin2_w")}


def t(a):
    return torch.from_numpy(np.array(a))


def _assert_fused_eq(got, want, exact_frac=0.95):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = max(np.abs(w).max(), 1.0)
    np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * scale)
    assert (g == w).mean() >= exact_frac
    assert np.abs(g - w).mean() < 2e-3 * scale


def _to_port(jcfg, p):
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig

    cfg = port_config(jcfg, ResidualTransformerConfig)
    return load_nar(nar_reference_state_dict(jax.tree.map(np.asarray, p), cfg), cfg)


@functools.lru_cache(maxsize=None)
def _layer_nar():
    """A JAX NAR at D = 128 (2 heads of 64, FFN 384, 2 decoder layers) with
    the decoder's LN affines and biases moved off 1 / 0."""
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar

    cfg = ResidualTransformerConfig(n_text_vocab=32, dim=D, nhead=H, enc_layers=1,
                                    dec_layers=2, n_spk_layers=1, t_emb_dim=64, hidden_dim=F)
    p = jax.tree.map(np.asarray, init_nar(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(8)
    lay = p["decoder"]["layers"]
    for k in list(lay):
        if k.startswith("norm") or k.endswith("_b"):
            base = 1.0 if k.endswith("_w") else 0.0
            lay[k] = (base + 0.05 * rng.standard_normal(lay[k].shape)).astype(np.float32)
    return cfg, p


def _quantized(gsize, sites):
    """(JAX quantize_nar pytree, the port's model carried by the converter)
    for a group size and the weights the site set groups."""
    from mars5_tts_tpu.ops.quant import quantize_nar

    cfg, p = _layer_nar()
    keys = tuple(k for s in sites for k in SITE_KEYS.get(s, ()))
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, p), w_gsize=gsize,
                                               w_group_keys=keys))
    return pq, _to_port(cfg, pq)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape,gsize", [((64, 128), 32), ((3, 40, 256), 64), ((96, 384), 128),
                                         ((8, 96), 96)])
def test_quantize_weight_grouped_bit_identical(shape, gsize):
    from mars5_tts_tpu.ops.quant import quantize_weight_grouped as jq
    from mars5_tts_torch.ops.quant import quantize_weight_grouped

    w = np.random.default_rng(gsize).standard_normal(shape).astype(np.float32) * 0.1
    w[..., 0, :gsize] = 0.0                     # an all-zero group: scale 0, codes 0
    want_q, want_s = (np.asarray(a) for a in jq(jnp.asarray(w), gsize))
    q, sg = quantize_weight_grouped(t(w), gsize)
    assert q.dtype == torch.int8 and sg.dtype == torch.float32
    assert sg.shape == want_s.shape == (*shape[:-2], shape[-1] // gsize, shape[-2])
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(sg.numpy(), want_s)
    with pytest.raises(ValueError, match="divide"):
        quantize_weight_grouped(t(w), gsize + 1)


@pytest.mark.parametrize("gsize,sites", [(32, ("qkv", "caq", "ffn")),
                                         (128, ("qkv", "saout", "caout", "ffn"))])
def test_quantize_nar_grouped_bit_identical_and_converted(gsize, sites):
    """The port's ``quantize_nar(w_gsize=, w_group_keys=)`` equals the JAX
    package's carried across by the converter, weight by weight: grouped
    where the key is named and gsize divides K (at 128, lin2's K = 384
    does not: per-row, as JAX falls back), per-row elsewhere; a second pass
    changes nothing, and a pass in the other mode raises in both packages."""
    from mars5_tts_tpu.ops.quant import quantize_nar as jq
    from mars5_tts_torch.ops.quant import nar_w_group_keys, quantize_nar

    cfg, p = _layer_nar()
    pq, carried = _quantized(gsize, sites)
    keys = nar_w_group_keys(sites)
    assert keys == tuple(k for s in sites for k in SITE_KEYS.get(s, ()))
    dense = _to_port(cfg, p)
    mine = quantize_nar(dense, w_gsize=gsize, w_group_keys=keys)
    sd_m, sd_c = mine.state_dict(), carried.state_dict()
    assert sd_m.keys() == sd_c.keys()
    for k in sd_m:
        assert sd_m[k].dtype == sd_c[k].dtype and torch.equal(sd_m[k], sd_c[k]), k
    dec = mine.tfm.decoder.layers[0]
    assert dec.self_attn.in_proj_weight.grouped == ("qkv" in sites)
    assert dec.self_attn.in_proj_weight.sg.shape == (D // gsize, 3 * D)
    assert dec.activation.W.weight.grouped and dec.activation.V.weight.grouped
    assert dec.linear2.weight.grouped == (F % gsize == 0)
    assert not dec.multihead_attn.in_proj_weight.grouped
    assert not mine.tfm.encoder.layers[0].self_attn.in_proj_weight.grouped
    with pytest.raises(AttributeError):                    # no per-row scale to misuse
        dec.activation.W.weight.s
    assert quantize_nar(mine, w_gsize=gsize, w_group_keys=keys) is mine
    with pytest.raises(ValueError, match="already quantized"):
        quantize_nar(mine)
    with pytest.raises(ValueError, match="already quantized"):
        jq(jax.tree.map(jnp.asarray, pq))


def test_linear_w8a8_grouped_matches_jax():
    from mars5_tts_tpu.ops.quant import linear_w8a8_grouped as jl
    from mars5_tts_tpu.ops.quant import quantize_weight_grouped as jq
    from mars5_tts_torch.ops.quant import QuantWeight, linear_any, quantize_weight_grouped

    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 256)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32) * 0.1
    q, sg = jq(jnp.asarray(w), 64)
    want = np.asarray(jl(jnp.asarray(x), q, sg, jnp.asarray(b)))
    got = linear_any(t(x), QuantWeight(*quantize_weight_grouped(t(w), 64)[:1],
                                       sg=quantize_weight_grouped(t(w), 64)[1]), t(b))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ K3 / K4 grouped

def _gemm_inputs(k, n, gsize, w_grouped, seed):
    """(x (M, K) f32 on bf16 values, JAX (wq, ws (wG, N)), the port's (q, s))."""
    from mars5_tts_torch.ops.quant import quantize_weight, quantize_weight_grouped

    rng = np.random.default_rng(seed)
    x = t(rng.standard_normal((50, k)).astype(np.float32) * 2).bfloat16().float()
    w = t(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
    q, s = quantize_weight_grouped(w, gsize) if w_grouped else quantize_weight(w)
    return x, (jnp.asarray(q.numpy()), jnp.asarray(s.reshape(-1, n).numpy())), (q, s)


@pytest.mark.parametrize("gsize,w_grouped", [(32, True), (64, True), (32, False), (64, False),
                                             (256, True)])
def test_grouped_qdot_bitwise_jax(gsize, w_grouped):
    """The grouped GEMM part of K3/K4 (``_qdot``): per (row, group) int8
    activations, exact int32 partials, each rescaled and summed in group
    order, bit for bit the JAX package's on the same f32 input."""
    from mars5_tts_tpu.ops.pallas.nar_fused import _qdot_ref
    from mars5_tts_torch.ops.kernels.nar_fused import _qdot

    k, n = 256, 192
    x, (jwq, jws), w = _gemm_inputs(k, n, gsize, w_grouped, gsize + w_grouped)
    want = np.asarray(_qdot_ref(jnp.asarray(x.numpy()), jwq, jws, k // gsize))
    got = _qdot(x, w, k // gsize)
    np.testing.assert_array_equal(got.numpy(), want)


def _jw(w, stacked=False):
    """The port's (q, s) pair as a JAX quant dict."""
    q, s = (jnp.asarray(a.numpy()) for a in w)
    return {"q": q, ("sg" if s.ndim == 2 else "s"): s, "a8": jnp.zeros(())}


@pytest.mark.parametrize("variant,gsize,w_grouped", [
    ("ln_bias", 32, True), ("ln_bias", 64, False), ("residual", 64, True), ("plain", 32, False)])
def test_fused_linear_grouped_ref_matches_jax(variant, gsize, w_grouped):
    """``fused_linear_ref(groups=)`` against JAX ``fused_linear_ref`` (the
    jnp emulation) and ``fused_linear(interpret=True)``, with weight scales
    per group (wG = G) or per row (wG = 1, the caq site)."""
    from mars5_tts_tpu.ops.pallas import nar_fused as JF
    from mars5_tts_torch.ops.kernels.nar_fused import fused_linear_ref

    k, n = D, 3 * D
    rng = np.random.default_rng(gsize * 3 + w_grouped)
    x = jnp.asarray(rng.standard_normal((2, 48, k)).astype(np.float32), jnp.bfloat16)
    _, _, w = _gemm_inputs(k, n, gsize, w_grouped, 5)
    kw, tkw = {}, {}
    if variant == "ln_bias":
        ln = (jnp.asarray(1 + 0.1 * rng.standard_normal(k).astype(np.float32)),
              jnp.asarray(0.1 * rng.standard_normal(k).astype(np.float32)))
        kw = dict(ln=ln, bias=jnp.asarray(0.1 * rng.standard_normal(n).astype(np.float32)))
        tkw = dict(ln=(t(ln[0]), t(ln[1])), bias=t(kw["bias"]))
    elif variant == "residual":
        res = jnp.asarray(rng.standard_normal((2, 48, n)).astype(np.float32), jnp.bfloat16)
        kw, tkw = dict(residual=res), dict(residual=t(res.astype(jnp.float32)).bfloat16())
    g = k // gsize
    got = fused_linear_ref(t(x.astype(jnp.float32)).bfloat16(), w, groups=g, **tkw)
    for want in (JF.fused_linear_ref(x, _jw(w), groups=g, **kw),
                 JF.fused_linear(x, _jw(w), groups=g, bm=64, interpret=True, **kw)):
        _assert_fused_eq(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("gsize,gsize2", [(32, 32), (64, 128), (64, 0)])
def test_fused_ffn_grouped_ref_matches_jax(gsize, gsize2):
    """``fused_ffn_ref(groups=, groups2=)`` against JAX ``fused_ffn_ref`` and
    ``fused_ffn(interpret=True)``; the tolerance of the ungrouped FFN test
    (two chained quant GEMMs: 40% exactly equal)."""
    from mars5_tts_tpu.ops.pallas import nar_fused as JF
    from mars5_tts_torch.ops.kernels.nar_fused import fused_ffn_ref

    rng = np.random.default_rng(gsize + gsize2)
    x = jnp.asarray(rng.standard_normal((2, 48, D)).astype(np.float32), jnp.bfloat16)
    ln = (jnp.asarray(1 + 0.1 * rng.standard_normal(D).astype(np.float32)),
          jnp.asarray(0.1 * rng.standard_normal(D).astype(np.float32)))
    b2 = jnp.asarray(0.1 * rng.standard_normal(D).astype(np.float32))
    _, _, w = _gemm_inputs(D, F, gsize, True, 1)
    _, _, v = _gemm_inputs(D, F, gsize, True, 2)
    _, _, l2 = _gemm_inputs(F, D, gsize2 or F, bool(gsize2), 3)
    wv = (torch.cat([w[0], v[0]]), torch.cat([w[1], v[1]], dim=-1))
    g, g2 = D // gsize, F // gsize2 if gsize2 else 1
    got = fused_ffn_ref(t(x.astype(jnp.float32)).bfloat16(), (t(ln[0]), t(ln[1])), w, v, l2,
                        t(b2), groups=g, groups2=g2)
    for fn, extra in ((JF.fused_ffn_ref, {}), (JF.fused_ffn, dict(bm=64, interpret=True))):
        want = fn(x, ln[0], ln[1], _jw(wv), _jw(l2), b2, groups=g, groups2=g2, **extra)
        _assert_fused_eq(got.float().numpy(), want.astype(jnp.float32), exact_frac=0.4)


def test_grouped_twins_refuse_mismatched_scales():
    from mars5_tts_torch.ops.kernels.nar_fused import fused_linear_ref

    x, _, (q, sg) = _gemm_inputs(128, 64, 32, True, 0)
    with pytest.raises(ValueError, match="groups"):
        fused_linear_ref(x, (q, sg), groups=2)              # sg has 4 groups
    with pytest.raises(ValueError, match="divide"):
        fused_linear_ref(x, (q, sg), groups=3)
    with pytest.raises(ValueError, match="groups"):
        fused_linear_ref(x, (q, sg))


# --------------------------------------------------------------- K1 int8

@pytest.mark.parametrize("lq,lk,masked", [(40, 40, True), (40, 40, False), (40, 13, True),
                                          (40, 13, False), (517, 517, True)])
def test_mha_int8_ref_matches_pallas_interpret(lq, lk, masked):
    """``mha_ref(quantized=True)`` against ``sdpa_pallas(interpret=True,
    quantized=True)``, self- and cross-attention, in f32 within the JAX
    test's mirror bound."""
    from mars5_tts_tpu.ops.pallas.mha import sdpa_pallas
    from mars5_tts_torch.ops.kernels.mha import mha_ref

    r = np.random.default_rng(lq * 3 + lk + masked)
    b, h, d = 2, 2, 64
    q = r.standard_normal((b, lq, h, d)).astype(np.float32) * 2
    k = r.standard_normal((b, lk, h, d)).astype(np.float32)
    v = r.standard_normal((b, lk, h, d)).astype(np.float32)
    mask = np.zeros((b, lk), bool)
    if masked:
        mask[1, lk - lk // 4:] = True
        mask[0, 2] = True
    jm = jnp.asarray(mask) if masked else None
    want = np.asarray(sdpa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                  interpret=True, quantized=True))
    got = mha_ref(t(q), t(k), t(v), t(mask) if masked else None, quantized=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------ routes of the layer

def _k1_route(monkeypatch, qattn, cross, min_len=16):
    """The JAX ``torch_mha``'s Pallas route on the CPU (interpret mode), with
    its int8 and cross knobs, and the port's K1 route (its twins), both
    from ``min_len`` queries."""
    import mars5_tts_tpu.ops.attention as JA
    import mars5_tts_tpu.ops.pallas as JP
    import mars5_tts_tpu.ops.pallas.mha as JM
    import mars5_tts_torch.ops.attention as PA

    monkeypatch.setattr(JP, "enabled", lambda: True)
    monkeypatch.setattr(JM, "sdpa_pallas", functools.partial(JM.sdpa_pallas, interpret=True))
    monkeypatch.setattr(JA, "_QATTN", qattn)
    monkeypatch.setattr(JA, "_CROSS_PALLAS", cross)
    monkeypatch.setattr(JA, "_PALLAS_SELF_ATTN_MIN_LEN", min_len)
    monkeypatch.setattr(PA, "KERNEL_SELF_ATTN_MIN_LEN", min_len)
    monkeypatch.setattr(PA, "kernel_route", lambda _t: True)


def _layer_inputs(i, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, D)).astype(np.float32)
    mem = rng.standard_normal((2, LK, D)).astype(np.float32)
    kpm = np.zeros((2, L), bool)
    kpm[1, L - 5:] = True
    mpm = np.zeros((2, LK), bool)
    mpm[0, LK - 3:] = True
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (x, mem, kpm, mpm), jd, td


def _jax_layer(pq, i, jd):
    lp = jax.tree.map(lambda a: jnp.asarray(a[i]), pq["decoder"]["layers"])
    lp = jax.tree.map(lambda a: a.astype(jd) if a.dtype == jnp.float32 else a, lp)
    for k in ("sa_in_w", "sa_out_w", "ca_in_w", "ca_out_w", "WV", "lin2_w"):
        sk = "sg" if "sg" in lp[k] else "s"
        lp[k][sk] = lp[k][sk].astype(jnp.float32)
    return lp


@pytest.mark.parametrize("sites,gsize", [
    (("qkv", "caq", "ffn"), 32), (("qkv", "saout", "caq", "caout", "ffn"), 64),
    (("saout", "caout"), 0), (("qkv", "saout", "caq", "caout", "ffn"), 0), (("ffn",), 32)])
def test_site_sets_match_decoder_layer_fused(monkeypatch, sites, gsize):
    """``forward_w8a8`` under ``NarOptions(sites=, gsize=)`` against JAX
    ``decoder_layer_fused(interpret=True)`` under ``MARS5_NARF_SITES`` /
    ``MARS5_NARF_GSIZE``, on the same weights (grouped where the sites'
    keys are), with both attentions' key-padding masks; bf16, the tolerance
    of the default-site test (40% exactly equal)."""
    import copy

    from mars5_tts_tpu.models.layers import decoder_layer_fused
    from mars5_tts_torch.models.layers import NarOptions

    monkeypatch.setenv("MARS5_NARF_SITES", ",".join(sites))
    monkeypatch.setenv("MARS5_NARF_GSIZE", str(gsize))
    cfg, _ = _layer_nar()
    pq, port = _quantized(gsize, sites)
    (x, mem, kpm, mpm), jd, td = _layer_inputs(1, "bf16", 11 + gsize + len(sites))
    want = decoder_layer_fused(_jax_layer(pq, 1, jd), jnp.asarray(x).astype(jd),
                               jnp.asarray(mem).astype(jd), cfg.nhead, jnp.asarray(kpm),
                               jnp.asarray(mpm), interpret=True)
    layer = copy.deepcopy(port.tfm.decoder.layers[1]).to(td)
    got = layer.forward_w8a8(t(x).to(td), t(mem).to(td), t(kpm), t(mpm),
                             options=NarOptions(sites=sites, gsize=gsize))
    assert got.dtype == td and got.shape == want.shape == (2, L, D)
    _assert_fused_eq(got.float().numpy(), np.asarray(want.astype(jnp.float32)), exact_frac=0.4)


@pytest.mark.parametrize("qattn,cross", [(False, False), (True, False), (False, True),
                                         (True, True)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unfused_layer_matches_decoder_layer(monkeypatch, qattn, cross, dtype):
    """The unfused W8A8 layer (``NarOptions(fused=False)``) against JAX
    ``decoder_layer`` under ``MARS5_NAR_FUSED=0``, with K1's route from 16
    queries: plain attention, the int8 self-attention (``qattn``), the bf16
    cross-attention through K1 (``cross``) and both in int8. f32: the max
    and mean bounds; bf16: also 40% exactly equal."""
    import copy

    from mars5_tts_tpu.models.layers import decoder_layer
    from mars5_tts_torch.models.layers import NarOptions

    monkeypatch.setenv("MARS5_NAR_FUSED", "0")
    _k1_route(monkeypatch, qattn, cross)
    cfg, _ = _layer_nar()
    pq, port = _quantized(0, ())
    (x, mem, kpm, mpm), jd, td = _layer_inputs(0, dtype, 21 + 2 * qattn + cross)
    want = decoder_layer(_jax_layer(pq, 0, jd), jnp.asarray(x).astype(jd),
                         jnp.asarray(mem).astype(jd), cfg.nhead, jnp.asarray(kpm),
                         jnp.asarray(mpm))
    layer = copy.deepcopy(port.tfm.decoder.layers[0]).to(td)
    opts = NarOptions(fused=False, qattn=qattn, cross_k1=cross)
    got = layer(t(x).to(td), t(mem).to(td), t(kpm), t(mpm), opts)
    assert got.dtype == td and got.shape == want.shape == (2, L, D)
    _assert_fused_eq(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                     exact_frac=0.4 if dtype == "bf16" else 0.0)


def test_k1_modes_are_taken_where_jax_takes_sdpa_pallas(monkeypatch):
    """Which attentions of the unfused layer reach K1, and in which mode:
    self at 40 >= 16 queries always, int8 only with ``qattn``; cross only
    with ``cross_k1``, int8 with both; none below the threshold."""
    import mars5_tts_torch.ops.kernels.mha as PK
    from mars5_tts_torch.models.layers import NarOptions

    _, port = _quantized(0, ())
    layer = port.tfm.decoder.layers[0]
    calls = []
    real = PK.mha

    def spy(q, k, v, mask=None, quantized=False):
        calls.append((q.shape[1], k.shape[1], quantized))
        return real(q, k, v, mask, quantized)

    monkeypatch.setattr(PK, "mha", spy)
    (x, mem, kpm, mpm), _, _ = _layer_inputs(0, "f32", 1)
    for qattn, cross, want in (
            (False, False, [(L, L, False)]), (True, False, [(L, L, True)]),
            (False, True, [(L, L, False), (L, LK, False)]),
            (True, True, [(L, L, True), (L, LK, True)])):
        _k1_route(monkeypatch, qattn, cross)
        calls.clear()
        layer(t(x), t(mem), t(kpm), t(mpm), NarOptions(fused=False, qattn=qattn,
                                                        cross_k1=cross))
        assert calls == want, (qattn, cross, calls)
    _k1_route(monkeypatch, True, True, min_len=L + 1)
    calls.clear()
    layer(t(x), t(mem), t(kpm), t(mpm), NarOptions(fused=False, qattn=True, cross_k1=True))
    assert calls == []


# ------------------------------------------------------ whole trajectories

def _clear_jax_scans():
    from mars5_tts_tpu.diffusion.engine import _diffusion_scan, _diffusion_scan_serving
    _diffusion_scan.clear_cache()
    _diffusion_scan_serving.clear_cache()


def _trajectory(monkeypatch, env, options, gsize, keys):
    """Injected uniforms, T = 4, deep clone with CFG, the tiny f32 NAR under
    the JAX package's ``quantize_nar(w_gsize=gsize, w_group_keys=keys)``
    (the grouped JAX NAR built directly: its ``Mars5TTS`` groups only with
    Pallas live) under ``env``; returns (the JAX grid, the port's grid on the
    converted weights under ``options``)."""
    from mars5_tts_tpu.config import DSH
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_tpu.ops.quant import quantize_nar
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion

    k_cls = 1025
    cfgs, params = tiny_models()
    pq = jax.tree.map(np.asarray, quantize_nar(jax.tree.map(jnp.asarray, params["nar"]),
                                               w_gsize=gsize, w_group_keys=keys))
    nar = _to_port(cfgs["nar"], pq)
    rng = np.random.default_rng(2)
    gen, n_prompt, text_len = 21, 13, 9
    x = np.repeat(rng.integers(0, 1024, gen)[None, :, None], 8, axis=2)
    batch = (rng.integers(0, 258, (1, text_len)), rng.integers(0, 1024, (1, n_prompt, 8)),
             np.asarray([text_len]), np.asarray([n_prompt]), x, np.zeros((1, gen), bool))
    steps = 4
    dsh = DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True,
              jump_len=1, jump_n_sample=1, q0_override_steps=2,
              enable_kevin_scaled_inference=True)
    n_steps = len(build_step_plan(steps)[0])
    uni = rng.random((n_steps, 2, 1, n_prompt + gen, 8, k_cls)).astype(np.float32)
    x_init = rng.integers(0, k_cls, (1, gen, 8))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _clear_jax_scans()          # the knobs are read at trace time
    try:
        want = np.asarray(j_infer(jax.tree.map(jnp.asarray, pq), cfgs["nar"], batch,
                                  JDiff(k_cls, steps), steps, dsh, uniforms=uni,
                                  x_init=x_init))
    finally:
        _clear_jax_scans()
    got = perform_simple_inference(nar, batch, MultinomialDiffusion(k_cls, steps), steps, dsh,
                                   uniforms=uni, x_init=x_init, options=options).numpy()
    return want, got


def _within_w8a8_limit(got, want):
    assert got.shape == want.shape == (1, 21, 8)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])     # L0: the AR codes
    assert (got != want).mean() <= 0.04


def test_grouped_trajectory_matches_jax(monkeypatch):
    """The grouped NAR (gsize 32, the default sites' keys) through the fused
    layer: the JAX engine with ``MARS5_NARF_GSIZE=32`` and its fused kernels
    in interpret mode against the port's twins with ``nar_gsize=32``."""
    from mars5_tts_torch.models.layers import NarOptions
    from mars5_tts_torch.ops.quant import nar_w_group_keys

    sites = NarOptions().sites
    want, got = _trajectory(monkeypatch, {"MARS5_NARF_GSIZE": "32",
                                          "MARS5_NAR_FUSED_INTERPRET": "1"},
                            NarOptions(gsize=32), 32, nar_w_group_keys(sites))
    _within_w8a8_limit(got, want)


def test_unfused_int8_attention_trajectory_matches_jax(monkeypatch):
    """The unfused W8A8 NAR with int8 attention and cross-attention through
    K1 (from 16 queries): the JAX engine under ``MARS5_NAR_FUSED=0`` with its
    Pallas attention in interpret mode against the port's twins."""
    from mars5_tts_torch.models.layers import NarOptions

    _k1_route(monkeypatch, True, True)
    want, got = _trajectory(monkeypatch, {"MARS5_NAR_FUSED": "0"},
                            NarOptions(fused=False, qattn=True, cross_k1=True), 0, ())
    _within_w8a8_limit(got, want)


def test_k1_refuses_autograd_on_its_cuda_route(monkeypatch):
    """K1 has no backward (nor has ``sdpa_pallas``, whose ``jax.grad`` fails
    to linearize): on its CUDA route ``mha`` raises when autograd records
    and q, k or v needs a gradient, never falling back to the twin. Driven
    on the CPU by taking the kernel route (``kernel_route``, the 512-query
    threshold) and the CUDA branch of the wrapper (``takes_twin``); under
    ``no_grad`` the call goes past the refusal to the device check."""
    import mars5_tts_torch.ops.attention as PA
    from mars5_tts_torch.models.convert import load_nar, nar_reference_state_dict
    from mars5_tts_torch.models.nar import ResidualTransformerConfig
    from mars5_tts_torch.ops.kernels import mha as K

    monkeypatch.setattr(PA, "KERNEL_SELF_ATTN_MIN_LEN", 8)
    monkeypatch.setattr(PA, "kernel_route", lambda _t: True)
    monkeypatch.setattr(K, "takes_twin", lambda _q: False)
    cfgs, params = tiny_models()
    pcfg = port_config(cfgs["nar"], ResidualTransformerConfig)
    nar = load_nar(nar_reference_state_dict(params["nar"], pcfg), pcfg, trainable=True)
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.integers(0, 32, (1, 5))),
            torch.from_numpy(rng.integers(0, 1024, (1, 4, 8))), torch.tensor([5]),
            torch.tensor([4]), torch.from_numpy(rng.integers(0, 1024, (1, 12, 8))),
            torch.zeros((1, 12), dtype=torch.bool), torch.tensor([3]))
    n0 = K.launch_count
    with pytest.raises(RuntimeError, match="no backward"):
        nar(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        nar(*args)
    q = torch.zeros((1, 12, 4, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.mha(q, q.detach(), q.detach())
    with torch.inference_mode(), pytest.raises(ValueError, match="unsupported device"):
        K.mha(q, q, q)
    assert K.launch_count == n0


# ------------------------------------------- f32 attention scores (MARS5_SDPA_BF16=0)

SDPA_GRID_BOUND = 0.02


def _sdpa_both(monkeypatch, flag, q, k, v, mask):
    import mars5_tts_tpu.ops.attention as JA
    import mars5_tts_torch.ops.attention as PA

    monkeypatch.setenv("MARS5_SDPA_BF16", flag)
    jax.clear_caches()
    j = JA.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask))
    p = PA.sdpa(*(t(a).bfloat16() for a in (q, k, v)), t(mask), scores_bf16=flag == "1")
    return np.asarray(j.astype(jnp.float32)), p.float().numpy()


def test_sdpa_scores_option_follows_the_jax_switch(monkeypatch):
    """``sdpa(scores_bf16=False)`` against JAX ``sdpa`` under
    ``MARS5_SDPA_BF16=0`` and the default against ``=1``, bf16 inputs: within
    a bf16 rounding (the f32 score and PV sums are ordered
    differently by XLA and PyTorch, and now and then round to the other bf16
    neighbour: 1 to 4 of 3,840 outputs here, in either mode). The switch
    moves both packages' outputs; f32 inputs ignore it. Bound: 2^-8 of the
    output's peak (a near-zero output is a sum that cancels, so its bf16
    neighbour is many of its own ulps away), at under 1% of the outputs."""
    import mars5_tts_torch.ops.attention as PA

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, n, 4, 16)).astype(np.float32) for n in (30, 30, 30))
    mask = np.ones((2, 1, 1, 30), bool)
    mask[1, ..., -3:] = False
    outs = {flag: _sdpa_both(monkeypatch, flag, q, k, v, mask) for flag in ("1", "0")}
    jax.clear_caches()
    for j, p in outs.values():
        assert np.abs(p - j).max() <= 2.0 ** -8 * np.abs(j).max()
        assert (p != j).mean() < 0.01
    assert not np.array_equal(outs["1"][0], outs["0"][0])
    assert not np.array_equal(outs["1"][1], outs["0"][1])
    f32 = [PA.sdpa(t(q), t(k), t(v), t(mask), scores_bf16=s) for s in (True, False)]
    assert torch.equal(*f32)


def test_nar_sdpa_bf16_option_reaches_every_plain_attention(monkeypatch):
    """A bf16 NAR (the bf16 backend) through the port's engine with
    ``NarOptions(sdpa_bf16=False)`` and through JAX's under
    ``MARS5_SDPA_BF16=0``, on the same uniforms and initial noise: L0 (the
    AR's codes) identical and at most 2% of the grid cells apart, as with
    the default scores against ``=1`` (the bf16 NAR is not bitwise between
    the packages: see the test above). The option changes the port's
    logits: the speaker encoder, the encoder and the decoder all read it."""
    from mars5_tts_tpu.config import DSH as JDSH
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_tpu.diffusion.schedule import build_step_plan
    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference as p_infer
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff
    from mars5_tts_torch.models.layers import NarOptions
    from tests.torch_port_fixtures import port_nar

    cfgs, params = tiny_models()
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                      if a.dtype == np.float32 else jnp.asarray(a), params["nar"])
    nar = port_nar(cfgs["nar"], params["nar"]).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    steps, n_prompt, gen, text_len = 6, 30, 20, 10
    codes = rng.integers(0, 1024, (1, n_prompt, 8))
    x = np.repeat(rng.integers(0, 1024, (1, gen, 1)), 8, axis=2)
    batch = (rng.integers(0, 258, (1, text_len)), codes, np.asarray([text_len]),
             np.asarray([n_prompt]), x, np.zeros((1, gen), bool))
    kw = dict(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True, jump_len=1,
              jump_n_sample=1, q0_override_steps=2, enable_kevin_scaled_inference=True)
    n_steps = len(build_step_plan(steps)[0])
    uni = rng.random((n_steps, 2, 1, n_prompt + gen, 8, 1025)).astype(np.float32)
    x_init = rng.integers(0, 1025, x.shape)
    for flag in ("1", "0"):
        monkeypatch.setenv("MARS5_SDPA_BF16", flag)
        jax.clear_caches()
        gj = np.asarray(j_infer(jp, cfgs["nar"], batch, JDiff(1025, steps), steps, JDSH(**kw),
                                uniforms=uni, x_init=x_init))
        gp = p_infer(nar, batch, PDiff(1025, steps), steps, DSH(**kw), uniforms=uni,
                     x_init=x_init, options=NarOptions(sdpa_bf16=flag == "1")).numpy()
        np.testing.assert_array_equal(gp[..., 0], gj[..., 0])
        assert (gp != gj).mean() <= SDPA_GRID_BOUND, (flag, (gp != gj).sum())
    jax.clear_caches()
    args = [t(a) for a in batch] + [torch.tensor([3])]
    with torch.no_grad():
        logits = [nar.heads(nar.backbone(*args, options=NarOptions(sdpa_bf16=s)))
                  for s in (True, False)]
        spk = [nar.spk_embedding(t(codes), torch.tensor([n_prompt]), NarOptions(sdpa_bf16=s))
               for s in (True, False)]
    assert not torch.equal(*logits) and not torch.equal(*spk)
