"""The quantized AR decode engine of the port (``ar_backend="fused"`` /
``"fused4"``): its pack, kernel K2's plain twin ``fused_step_ref``, kernel
K8's twin ``head4_logits_ref``, the engine and the pipeline, against the JAX
package at small geometry (the JAX fused tests' ring-wrapping geometry for
the kernel and the engine, a 256-wide AR for the pipeline).

* The W8 pack is bit-identical to the JAX ``prepare_fused`` pack carried over
  by ``fused_pack_from_jax``. The W4 pack is too, except rows whose two best
  clip ratios' squared errors tie within 1e-6 relative (summed in another
  order by XLA and by PyTorch); the count is printed.
* ``fused_step_ref`` against ``fused_step_emulation`` (W8, W4, before and
  after the ring wraps): h atol 1e-5, k/v atol 1e-6, the JAX kernel tests'
  bound; once against the Pallas kernel in interpret mode.
* ``ar_generate_fused`` token-identical to the JAX engine under shared
  uniforms; ``Mars5TTS(ar_backend="fused4", nar_backend="int8")`` gives the JAX
  pipeline's AR tokens and its grid within the W8A8 NAR's 4%-of-cells bound
  (``tests/test_torch_diffusion_tail.py``).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from mars5_tts_tpu.models.ar import CodecLMConfig  # noqa: E402
from tests.torch_port_fixtures import (fused_ar, make_tokenizers, port_codeclm,  # noqa: E402
                                       port_nar, tiny_models)

# the JAX fused tests' geometry (tests/test_fused_decode.py): the ring wraps
CFG = CodecLMConfig(n_vocab=512, dim=256, n_heads=4, n_kv_heads=4, head_dim=64, n_layers=3,
                    hidden_dim=512, sliding_window=24, n_spk_layers=2, spk_hidden_dim=256)
MAX_LEN = 40
H_ATOL, KV_ATOL = 1e-5, 1e-6
SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.2, n_phones_gen=100, eos_idx=0,
                valid_start=10, valid_end=510, max_len=MAX_LEN)


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def models():
    """(JAX f32 params, the port's CodecLM) of CFG."""
    from mars5_tts_tpu.models.ar import init_codeclm

    params = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(0), CFG))
    return params, port_codeclm(CFG, params)


@functools.lru_cache(maxsize=None)
def jax_fused(wbits):
    from mars5_tts_tpu.models.ar_decode_fused import prepare_fused

    return prepare_fused(jax.tree.map(jnp.asarray, models()[0]), CFG, max_len=MAX_LEN,
                         wbits=wbits)


@functools.lru_cache(maxsize=None)
def port_fused(wbits):
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused

    return prepare_fused(models()[1], MAX_LEN, wbits)


def converted(wbits):
    from mars5_tts_torch.models.convert import fused_pack_from_jax

    return fused_pack_from_jax(jax.tree.map(np.asarray, jax_fused(wbits)[0]))


# ---------------------------------------------------------------------- pack

BACKBONE = ("wqkv", "sqkv", "wo", "so", "w13", "s13", "w2", "s2", "attn_norms", "ffn_norms")


def test_pack_w8_bit_identical():
    mine, dims = port_fused(8)
    theirs = converted(8)
    assert dims.window == jax_fused(8)[1].window == 24
    for k in BACKBONE + ("head_q", "head_s"):
        assert mine[k].dtype == theirs[k].dtype, k
        assert torch.equal(mine[k], theirs[k]), k
    assert torch.equal(mine["final_norm"], theirs["final_norm"])
    assert torch.equal(mine["embed"], theirs["embed"])


def _w4_rows(fp):
    """name -> (int values (L, N, G, K/G), scales (L, N, G)) of a W4 pack:
    G = 2 halves with a scale each, or 1 (w2)."""
    from mars5_tts_torch.ops.kernels.decode_layer import unpack4

    out = {}
    for name in ("wqkv", "wo", "w13"):
        lo, hi = unpack4(fp[name])
        out[name] = (torch.stack([lo, hi], dim=2), fp["s" + name[1:]].transpose(1, 2))
    lo, hi = unpack4(fp["w2"])
    out["w2"] = (torch.cat([lo, hi], dim=-1)[:, :, None], fp["s2"][..., None])
    return out


def _weights(port):
    """name -> float weights (L, N, G, K/G) matching ``_w4_rows``."""
    layers = port.ar.layers
    w = {"wqkv": [torch.cat([l.attention.wq.weight, l.attention.wk.weight,
                             l.attention.wv.weight]) for l in layers],
         "wo": [l.attention.wo.weight for l in layers],
         "w13": [torch.cat([l.feed_forward.w1.weight, l.feed_forward.w3.weight])
                 for l in layers],
         "w2": [l.feed_forward.w2.weight for l in layers]}
    out = {}
    for k, v in w.items():
        a = torch.stack(v).float()
        g = 1 if k == "w2" else 2
        out[k] = a.reshape(a.shape[0], a.shape[1], g, -1)
    return out


def _sq_err(w, s):
    return float((torch.round(w / s).clamp(-7, 7) * s - w).double().square().sum())


def test_pack_w4_identical_except_clip_ties():
    mine, theirs = _w4_rows(port_fused(4)[0]), _w4_rows(converted(4))
    weights = _weights(models()[1])
    ties = 0
    for name, (qm, sm) in mine.items():
        qt, st = theirs[name]
        same = sm == st
        assert torch.equal(qm[same], qt[same]), name
        for idx in (~same).nonzero().tolist():
            w = weights[name][tuple(idx)]
            em, et = _sq_err(w, sm[tuple(idx)]), _sq_err(w, st[tuple(idx)])
            assert abs(em - et) <= 1e-6 * max(em, et), (name, idx, em, et)
            ties += 1
    print(f"W4 pack: {ties} half-rows chose another clip ratio (tied errors)")
    assert ties <= 3


def test_quantizers_rope_and_nibbles_match_jax():
    from mars5_tts_tpu.ops.pallas import decode_layer as JD
    from mars5_tts_tpu.ops.quant import quantize_weight_mse as j_mse
    from mars5_tts_torch.ops.kernels import decode_layer as D
    from mars5_tts_torch.ops.quant import quantize_weight_mse

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 256)) * 0.3).astype(np.float32)
    x[0, 0] = 0.0
    jq, js = JD.quantize_kv_rows(jnp.asarray(x))
    pq, ps = D.quantize_kv_rows(t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))

    w = (rng.standard_normal((64, 384)) * 0.05).astype(np.float32)
    jq, js = j_mse(jnp.asarray(w), levels=7)
    pq, ps = quantize_weight_mse(t(w), levels=7)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))

    dims = D.make_dims(CFG, 2000)
    for pos in (0, 5, 30, 1999):
        jc, jsn = JD._rope_flat(jnp.int32(pos), jax_fused(8)[1])
        pc, psn = D.rope_flat(pos, dims, "cpu")
        np.testing.assert_array_max_ulp(pc.numpy(), np.asarray(jc)[0, :32], maxulp=1)
        np.testing.assert_array_max_ulp(psn.numpy(), np.asarray(jsn)[0, :32], maxulp=1)
        np.testing.assert_array_equal(np.asarray(jc)[0, :32], np.asarray(jc)[0, 32:64])

    qa = rng.integers(-8, 8, (16, 96)).astype(np.int8)
    qb = rng.integers(-8, 8, (16, 96)).astype(np.int8)
    packed = D.pack4(t(qa), t(qb))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JD._pack4(jnp.asarray(qa),
                                                                       jnp.asarray(qb))))
    lo, hi = D.unpack4(packed)
    np.testing.assert_array_equal(lo.numpy(), qa)
    np.testing.assert_array_equal(hi.numpy(), qb)


# ------------------------------------------------------------------ the step

def _step_inputs(dims, pos):
    """The JAX fused tests' random int8 ring caches (made with
    quantize_kv_rows), an embedded-token block and the JAX (L, 2, W_pad) scales."""
    from mars5_tts_tpu.ops.pallas.decode_layer import quantize_kv_rows

    caches = []
    for seed in (2, 3):
        c = np.random.default_rng(seed).standard_normal((dims.n_layers, dims.w_pad, dims.dim)) * 0.1
        c[:, dims.window:] = 0
        caches.append(quantize_kv_rows(jnp.asarray(c, jnp.float32)))
    (ck, ks), (cv, vs) = caches
    x = jax.random.normal(jax.random.PRNGKey(1), (8, dims.dim), jnp.bfloat16).at[1:].set(0)
    return x, ck, cv, jnp.stack([ks, vs], axis=1)


def _jax_rope_flat(pos, dims, device):
    """The JAX package's RoPE angles of ``pos``, as ``rope_flat`` gives them."""
    from mars5_tts_tpu.ops.pallas.decode_layer import _rope_flat

    cos, sin = _rope_flat(jnp.int32(pos), jax_fused(8)[1])
    return t(cos)[0, :dims.head_dim // 2], t(sin)[0, :dims.head_dim // 2]


def _jax_self_scores(qh, kh, scale):
    """The self score summed as the JAX emulation sums it: over a whole
    masked (H, d) row, by XLA."""
    n_heads, hd = qh.shape
    hmask = jnp.asarray(np.kron(np.eye(n_heads), np.ones((1, hd))), jnp.float32)
    qmat = hmask * jnp.asarray(qh.reshape(1, -1).numpy())
    s = jnp.sum(qmat * jnp.asarray(kh.reshape(1, -1).numpy()), axis=-1, keepdims=True) * scale
    return t(s)


def fused_eq(got, want):
    """The JAX kernel tests' bound (tests/test_nar_fused.py _assert_fused_eq):
    |diff| <= 0.02 x max(peak, 1) and mean |diff| < 2e-3 x max(peak, 1). Its
    third clause, > 95% of elements exact, is for bf16 outputs; these are f32
    and differ in the last ulp nearly everywhere, so it does not apply."""
    peak = max(np.abs(want).max(), 1.0)
    diff = np.abs(got - want)
    assert diff.max() <= 0.02 * peak and diff.mean() < 2e-3 * peak, (diff.max(), diff.mean())


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("pos", [5, 30])   # before and after the ring wraps (window 24)
def test_step_twin_matches_jax_emulation(wbits, pos, monkeypatch):
    """With the JAX RoPE angles and the JAX self-score sum, h within 1e-5
    and k/v within 1e-6 of the emulation; with the port's own (cos/sin and
    the 64-term sum differ in the last ulp, and a one-ulp move of the self
    score can move one int8 rounding: W4 at pos 5), within ``fused_eq``."""
    from mars5_tts_tpu.ops.pallas.decode_layer import fused_step_emulation
    from mars5_tts_torch.ops.kernels import decode_layer as D

    fp, jdims = jax_fused(wbits)
    x, ck, cv, kvs = _step_inputs(jdims, pos)
    h_e, k_e, v_e = (np.asarray(a) for a in fused_step_emulation(
        fp, x, jnp.int32(pos), ck, cv, kvs, dims=jdims, norm_eps=CFG.norm_eps))
    dims = port_fused(wbits)[1]
    args = (converted(wbits), t(x.astype(jnp.float32))[0:1].bfloat16(), pos, t(ck), t(cv),
            t(kvs))
    h, k, v = (a.numpy() for a in D.fused_decode_layers(*args, dims=dims,
                                                        norm_eps=CFG.norm_eps))
    assert h.shape == (1, 256) and k.shape == v.shape == (3, 1, 256)
    for got, want in ((h, h_e[0:1]), (k, k_e), (v, v_e)):
        fused_eq(got, want)
    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    h, k, v = D.fused_decode_layers(*args, dims=dims, norm_eps=CFG.norm_eps)
    np.testing.assert_allclose(h.numpy(), h_e[0:1], rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(k.numpy(), k_e, rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(v.numpy(), v_e, rtol=0, atol=KV_ATOL)


def test_step_twin_matches_pallas_kernel(monkeypatch):
    from mars5_tts_tpu.ops.pallas.decode_layer import fused_decode_layers as j_kernel
    from mars5_tts_torch.ops.kernels import decode_layer as D

    pos = 30
    fp, jdims = jax_fused(8)
    x, ck, cv, kvs = _step_inputs(jdims, pos)
    h_k, k_k, v_k = j_kernel(fp, x, jnp.int32(pos), ck, cv, kvs, dims=jdims,
                             norm_eps=CFG.norm_eps, interpret=True)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    h, k, v = D.fused_step_ref(port_fused(8)[0], t(x.astype(jnp.float32))[0:1].bfloat16(),
                               pos, t(ck), t(cv), t(kvs), dims=port_fused(8)[1],
                               norm_eps=CFG.norm_eps)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_k)[0:1], rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_k), rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_k), rtol=0, atol=KV_ATOL)


@pytest.mark.parametrize("pos", [5, 30])   # before and after the ring wraps (window 24)
def test_structure_oracle_matches_jax_emulation(pos, monkeypatch):
    """``fused_step_ref(quantized=False)`` (W8, float caches, no int8
    rounding) within 1e-5 of ``fused_step_emulation(quantized=False)`` with
    the JAX RoPE angles and self-score sum; W4 refused as JAX refuses it."""
    from mars5_tts_tpu.ops.pallas.decode_layer import fused_step_emulation
    from mars5_tts_torch.ops.kernels import decode_layer as D

    fp, jdims = jax_fused(8)
    x = _step_inputs(jdims, pos)[0]
    caches = []
    for seed in (4, 5):
        c = np.random.default_rng(seed).standard_normal((jdims.n_layers, jdims.w_pad, jdims.dim))
        c[:, jdims.window:] = 0
        caches.append(np.asarray(jnp.asarray(c * 0.3, jnp.bfloat16).astype(jnp.float32)))
    ck, cv = caches
    h_e, k_e, v_e = (np.asarray(a) for a in fused_step_emulation(
        fp, x, jnp.int32(pos), jnp.asarray(ck), jnp.asarray(cv), dims=jdims,
        norm_eps=CFG.norm_eps, quantized=False))
    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    h, k, v = D.fused_step_ref(converted(8), t(x.astype(jnp.float32))[0:1].bfloat16(), pos,
                               t(ck), t(cv), None, dims=port_fused(8)[1],
                               norm_eps=CFG.norm_eps, quantized=False)
    np.testing.assert_allclose(h.numpy(), h_e[0:1], rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(k.numpy(), k_e, rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(v.numpy(), v_e, rtol=0, atol=H_ATOL)
    quantized = D.fused_step_ref(converted(8), t(x.astype(jnp.float32))[0:1].bfloat16(), pos,
                                 *(t(a) for a in _step_inputs(jdims, pos)[1:]),
                                 dims=port_fused(8)[1], norm_eps=CFG.norm_eps)[0]
    assert not torch.equal(quantized, h)
    with pytest.raises(NotImplementedError):
        D.fused_step_ref(converted(4), t(x.astype(jnp.float32))[0:1].bfloat16(), pos,
                         t(ck), t(cv), None, dims=port_fused(4)[1], quantized=False)


def test_int4_amax_pack_bit_identical_to_jax(monkeypatch):
    """``Mars5TTS(int4_mse=False)``'s pack (``prepare_fused(int4_mse=False)``)
    bitwise the JAX ``prepare_fused`` pack under ``MARS5_INT4_MSE=0`` (amax
    scales have no clip-search ties); the default differs from it."""
    from mars5_tts_tpu.models.ar_decode_fused import prepare_fused as j_prepare
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused
    from mars5_tts_torch.models.convert import fused_pack_from_jax

    monkeypatch.setenv("MARS5_INT4_MSE", "0")
    jax.clear_caches()
    jfp, _ = j_prepare(jax.tree.map(jnp.asarray, models()[0]), CFG, max_len=MAX_LEN, wbits=4)
    theirs = fused_pack_from_jax(jax.tree.map(np.asarray, jfp))
    mine, _ = prepare_fused(models()[1], MAX_LEN, 4, int4_mse=False)
    for k in BACKBONE + ("head_q", "head_s"):
        assert mine[k].dtype == theirs[k].dtype, k
        assert torch.equal(mine[k], theirs[k]), k
    assert not torch.equal(port_fused(4)[0]["s2"], mine["s2"])


# -------------------------------------------------------------------- head4

def test_head4_twin_matches_jax():
    from mars5_tts_tpu.ops.pallas import head4 as JH
    from mars5_tts_torch.ops.kernels.head4 import head4_logits, head4_logits_ref, pack_head4

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((8, 256)), jnp.bfloat16)
    w = (rng.standard_normal((500, 256)) * 0.05).astype(np.float32)
    wp, ws = JH.pack_head4(jnp.asarray(w), bn=128)
    mp, ms = pack_head4(t(w))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(wp)[:500])
    np.testing.assert_array_equal(ms.numpy(), np.asarray(ws)[:, :500])
    want = np.asarray(JH.head4_logits_emulation(x, wp, ws, n_vocab=500))
    xt = t(x.astype(jnp.float32)).bfloat16()
    got = head4_logits_ref(xt, t(wp), t(ws), n_vocab=500)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * peak)
    np.testing.assert_allclose(head4_logits(xt, mp, ms, n_vocab=500).numpy(), want,
                               rtol=0, atol=1e-5 * peak)
    kernel = np.asarray(JH.head4_logits(x, wp, ws, n_vocab=500, bn=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=1e-5 * peak)


def _batched_inputs(jdims, positions):
    """Random int8 rings of B rows (the JAX batched test's), B embedded
    tokens in the JAX 8-row block, and the scales in the JAX (L, 2B, W_pad)
    and the port's (L, B, 2, W_pad) layouts."""
    from mars5_tts_tpu.ops.pallas.decode_layer import quantize_kv_rows

    b = len(positions)
    caches = []
    for seed in (2, 3):
        c = np.random.default_rng(seed).standard_normal(
            (jdims.n_layers, b, jdims.w_pad, jdims.dim)) * 0.1
        c[:, :, jdims.window:] = 0
        caches.append(quantize_kv_rows(jnp.asarray(c, jnp.float32)))
    (ck, ks), (cv, vs) = caches
    x = jax.random.normal(jax.random.PRNGKey(1), (8, jdims.dim), jnp.bfloat16).at[b:].set(0)
    return x, ck, cv, jnp.concatenate([ks, vs], axis=1), jnp.stack([ks, vs], axis=2)


@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("positions", [                 # both sides of the wrap (window 24)
    (5, 30, 17), (23, 24, 2), (9, 40), (0, 3, 11, 23, 24, 29, 35, 39)])
def test_batched_step_twin_matches_jax_emulation(wbits, positions, monkeypatch):
    """K2's twin with 2, 3 and 8 rows against ``fused_step_emulation_batched``:
    within ``fused_eq`` as it stands, and with the JAX RoPE angles and
    self-score sum within the JAX kernel tests' 1e-5 / 1e-6; each row equals
    the twin's one-row step."""
    import dataclasses

    from mars5_tts_tpu.ops.pallas.decode_layer import fused_step_emulation_batched
    from mars5_tts_torch.ops.kernels import decode_layer as D

    fp, jdims = jax_fused(wbits)
    jdims = dataclasses.replace(jdims, batch=len(positions))
    x, ck, cv, kvs_j, kvs_p = _batched_inputs(jdims, positions)
    h_e, k_e, v_e = (np.asarray(a) for a in fused_step_emulation_batched(
        fp, x, jnp.asarray(positions, jnp.int32), ck, cv, kvs_j, dims=jdims,
        norm_eps=CFG.norm_eps))
    b = len(positions)
    dims = port_fused(wbits)[1]
    args = (converted(wbits), t(x.astype(jnp.float32))[:b].bfloat16(), list(positions),
            t(ck), t(cv), t(kvs_p))
    h, k, v = (a.numpy() for a in D.fused_decode_layers(*args, dims=dims,
                                                        norm_eps=CFG.norm_eps))
    assert h.shape == (b, 256) and k.shape == v.shape == (CFG.n_layers, b, 256)
    for got, want in ((h, h_e[:b]), (k, k_e[:, :b]), (v, v_e[:, :b])):
        fused_eq(got, want)
    for i in range(b):
        one = D.fused_step_ref(args[0], args[1][i:i + 1], positions[i], args[3][:, i],
                               args[4][:, i], args[5][:, i], dims=dims, norm_eps=CFG.norm_eps)
        np.testing.assert_array_equal(one[0].numpy(), h[i:i + 1])
        np.testing.assert_array_equal(one[1].numpy(), k[:, i:i + 1])
    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    h, k, v = D.fused_decode_layers(*args, dims=dims, norm_eps=CFG.norm_eps)
    np.testing.assert_allclose(h.numpy(), h_e[:b], rtol=0, atol=H_ATOL)
    np.testing.assert_allclose(k.numpy(), k_e[:, :b], rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(v.numpy(), v_e[:, :b], rtol=0, atol=KV_ATOL)


def test_head4_twin_three_rows_equals_jax_emulation():
    from mars5_tts_tpu.ops.pallas import head4 as JH
    from mars5_tts_torch.ops.kernels.head4 import head4_logits, head4_logits_ref

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((3, 256)), jnp.bfloat16)
    wp, ws = JH.pack_head4(jnp.asarray((rng.standard_normal((500, 256)) * 0.05)
                                       .astype(np.float32)), bn=128)
    want = np.asarray(JH.head4_logits_emulation(x, wp, ws, n_vocab=500))
    xt = t(x.astype(jnp.float32)).bfloat16()
    got = head4_logits_ref(xt, t(wp), t(ws), n_vocab=500)
    assert got.shape == (3, 500)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(head4_logits(xt, t(wp), t(ws), n_vocab=500).numpy(), want)


# --------------------------------------------------------------- the engine

@pytest.mark.parametrize("wbits", [8, 4])
def test_generation_token_identical_to_jax(wbits):
    from mars5_tts_tpu.models import ar_decode as JA
    from mars5_tts_tpu.models.ar_decode_fused import ar_generate_fused as j_generate
    from mars5_tts_torch.models import ar_decode as PA
    from mars5_tts_torch.models.ar_decode_fused import ar_generate_fused

    params = jax.tree.map(jnp.asarray, models()[0])
    fp, jdims = jax_fused(wbits)
    pfp, dims = port_fused(wbits)
    if wbits == 4:
        pfp = {**pfp, **{k: converted(4)[k] for k in BACKBONE}}   # the same int4 values
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        prompt = rng.integers(10, 510, 10 + seed)
        spk = rng.integers(0, 1024, (20, 8))
        u = rng.random(MAX_LEN).astype(np.float32)
        tok_j, n_j = j_generate(params, fp, CFG, jdims, prompt, spk,
                                sampling=JA.ArSampling(**SAMPLING), uniforms=u, interpret=None)
        tok_p, n_p = ar_generate_fused(models()[1], pfp, dims, prompt, spk,
                                       sampling=PA.ArSampling(**SAMPLING), uniforms=u)
        np.testing.assert_array_equal(tok_p, tok_j, err_msg=f"seed {seed}")
        assert n_p == n_j and n_p > 0


# ------------------------------------------------------------- the pipeline

@functools.lru_cache(maxsize=None)
def _nar_draws(n_prompt, gen, steps):
    from mars5_tts_tpu.diffusion.schedule import build_step_plan

    rng = np.random.default_rng(n_prompt * 1000 + gen)
    n_steps = len(build_step_plan(steps)[0])
    return (rng.random((n_steps, 2, 1, n_prompt + gen, 8, 1025)).astype(np.float32),
            rng.integers(0, 1025, (1, gen, 8)))


def _port_tts(**kw):
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree

    cfg, params = fused_ar()
    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    return Mars5TTS.from_params(port_codeclm(cfg, params), port_nar(cfgs["nar"], tiny["nar"]),
                                texttok=texttok, speechtok=speechtok,
                                encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), **kw)


@pytest.mark.parametrize("ar_backend", ["fused4", "fused"])
def test_mars5tts_quantized_ar_int8_matches_jax_pipeline(monkeypatch, ar_backend):
    """The JAX production path (fused4 AR + int8 NAR) and its W8 twin through
    both pipelines with shared AR uniforms and NAR draws: identical AR codes,
    the grid within the W8A8 NAR's bound. The JAX side runs its fused AR
    emulation and its fused NAR kernels in interpret mode."""
    import mars5_tts_tpu.models.ar_decode_fused as JF
    import mars5_tts_tpu.pipeline as JP
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig

    monkeypatch.setenv("MARS5_FUSED_INTERPRET", "emu")
    monkeypatch.setenv("MARS5_NAR_FUSED_INTERPRET", "1")
    steps = 4
    u_ar = np.random.default_rng(9).random(4096).astype(np.float32)
    grids = {}

    def ar_with_uniforms(fn):
        def run(*a, sampling, seed=0, **k):
            return fn(*a, sampling=sampling, uniforms=u_ar[:sampling.max_len], **k)
        return run

    def nar_with_draws(fn, name, drop):
        def run(*a, **k):
            batch = a[2] if name == "jax" else a[1]
            uni, x_init = _nar_draws(np.shape(batch[1])[1], np.shape(batch[4])[1], steps)
            for key in drop:
                k.pop(key, None)
            grids[name] = np.asarray(fn(*a, uniforms=uni, x_init=x_init, **k))
            return grids[name]
        return run

    monkeypatch.setattr(JF, "ar_generate_fused", ar_with_uniforms(JF.ar_generate_fused))
    monkeypatch.setattr(PP, "ar_generate_fused", ar_with_uniforms(PP.ar_generate_fused))
    monkeypatch.setattr(JP, "perform_simple_inference",
                        nar_with_draws(JP.perform_simple_inference, "jax",
                                       ("key", "gen_bucket", "text_bucket")))
    monkeypatch.setattr(PP, "perform_simple_inference",
                        nar_with_draws(PP.perform_simple_inference, "port", ("generator",)))
    monkeypatch.setattr(PP, "ar_generate", lambda *a, **k: pytest.fail("bf16 AR engine ran"))

    cfg, params = fused_ar()
    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    jtts = JP.Mars5TTS.from_params(params, tiny["nar"], cfg, cfgs["nar"], texttok=texttok,
                                   speechtok=speechtok, encodec_params=tiny["encodec"],
                                   vocos_params=tiny["vocos"], encodec_cfg=cfgs["encodec"],
                                   vocos_cfg=cfgs["vocos"], ar_backend=ar_backend,
                                   nar_backend="int8")
    ptts = _port_tts(ar_backend=ar_backend, nar_backend="int8")
    ref = (np.random.default_rng(4).standard_normal(8 * 60) * 0.1).astype(np.float32)
    icfg = InferenceConfig(timesteps=steps, generate_max_len_override=100, trim_db=200)
    outs = {name: tts.tts("hi there", ref, ref_transcript="ok", cfg=icfg, seed=3)
            for name, tts in (("jax", jtts), ("port", ptts))}
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert len(outs["port"][0]) > 0
    assert grids["port"].shape == grids["jax"].shape
    np.testing.assert_array_equal(grids["port"][..., 0], grids["jax"][..., 0])
    assert (grids["port"] != grids["jax"]).mean() <= 0.04
    assert np.isfinite(outs["port"][1]).all()


def test_backend_arguments(monkeypatch):
    import mars5_tts_torch.pipeline as PP
    from mars5_tts_tpu.config import InferenceConfig

    for bad in ("int8", "fused8", "bf16 "):
        with pytest.raises(ValueError):
            _port_tts(ar_backend=bad)
    for backend in ("bf16", "fused"):
        with pytest.raises(ValueError):
            _port_tts(ar_backend=backend, head4=True)
    monkeypatch.setattr(PP, "ar_generate", lambda *a, **k: pytest.fail("bf16 AR engine ran"))
    tts = _port_tts(ar_backend="fused4", head4=True)
    ref = (np.random.default_rng(5).standard_normal(8 * 40) * 0.1).astype(np.float32)
    for max_len in (60, 61):
        codes, audio = tts.tts("yo", ref, ref_transcript="a", seed=1, cfg=InferenceConfig(
            timesteps=2, generate_max_len_override=max_len))
        assert np.isfinite(audio).all()
    fp60, fp61 = tts._fused_cache[60][0], tts._fused_cache[61][0]
    assert fp60 is fp61 and "head4_p" in fp60 and "head_q" not in fp60
    assert tts._fused_cache[61][1].window == 62


def _batched_case(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(10, 510, n) for n in (seed - 190, 6, 13)]
    spks = [rng.integers(0, 1024, (n, 8)) for n in (20, 9, 14)]
    return prompts, spks, rng.random((MAX_LEN, 3)).astype(np.float32), [3, 100, seed - 190]


def _batched_engines(wbits, seed, monkeypatch, eager=False):
    """(JAX tokens, port tokens, port one-row tokens) of ``_batched_case``:
    ``ar_generate_fused_batched`` of both packages (the JAX engine in
    emulation, jitted unless ``eager``) under one (max_len, 3) stream, the
    port's step with the JAX RoPE angles and self-score sum."""
    import dataclasses

    from mars5_tts_tpu.models import ar_decode as JA
    from mars5_tts_tpu.models.ar_decode_fused import ar_generate_fused_batched as j_generate
    from mars5_tts_torch.models import ar_decode as PA
    from mars5_tts_torch.models.ar_decode_fused import (ar_generate_fused,
                                                        ar_generate_fused_batched)
    from mars5_tts_torch.ops.kernels import decode_layer as D

    monkeypatch.setattr(D, "_self_scores", _jax_self_scores)
    monkeypatch.setattr(D, "rope_flat", _jax_rope_flat)
    params = jax.tree.map(jnp.asarray, models()[0])
    fp, jdims = jax_fused(wbits)
    pfp, dims = port_fused(wbits)
    if wbits == 4:
        pfp = {**pfp, **{k: converted(4)[k] for k in BACKBONE}}   # the same int4 values
    prompts, spks, u, est = _batched_case(seed)
    with jax.disable_jit(eager):
        outs_j = j_generate(params, fp, CFG, dataclasses.replace(jdims, batch=3), prompts, spks,
                            uniforms=u, est_lens=est, sampling=JA.ArSampling(**SAMPLING),
                            interpret=None)
    outs_p = ar_generate_fused_batched(models()[1], pfp, dataclasses.replace(dims, batch=3),
                                       prompts, spks, uniforms=u, est_lens=est,
                                       sampling=PA.ArSampling(**SAMPLING))
    solo = [ar_generate_fused(models()[1], pfp, dims, prompts[i], spks[i], uniforms=u[:, i],
                              sampling=PA.ArSampling(**{**SAMPLING, "n_phones_gen": est[i]}))
            for i in range(3)]
    return outs_j, outs_p, solo


@pytest.mark.parametrize("wbits", [8, 4])
def test_batched_generation_token_identical_to_jax(wbits, monkeypatch):
    """Three rows with their own prompt and speaker lengths and early-EOS
    estimates, seeds 200, 201, 203: the port's tokens equal the jitted JAX
    engine's, and each row its one-row run. With the port's own RoPE angles
    and self-score sum one int8 rounding moves in W8 at seed 201, row 2
    (ROADMAP C), so the step takes the JAX ones. Seeds 202 (W4) and 204 are
    not in this list: there the jitted JAX engine parts from its own eager
    trace at a nucleus cutoff (XLA rewrites the f32 filter ops), and the
    port follows the eager trace (the next test)."""
    for seed in (200, 201, 203):
        outs_j, outs_p, solo = _batched_engines(wbits, seed, monkeypatch)
        for i, ((tj, nj), (tp, n_p), (ts, ns)) in enumerate(zip(outs_j, outs_p, solo)):
            np.testing.assert_array_equal(tp, tj, err_msg=f"seed {seed} row {i}")
            np.testing.assert_array_equal(ts, tp, err_msg=f"seed {seed} row {i} solo")
            assert n_p == nj == ns


def test_batched_generation_follows_the_eager_jax_trace(monkeypatch):
    """Seed 204, W8: the JAX engine run op by op (``jax.disable_jit``) and
    the port give the same tokens in every row, where the jitted JAX engine
    parts at row 2's 11th draw."""
    outs_j, outs_p, solo = _batched_engines(8, 204, monkeypatch, eager=True)
    for i, ((tj, nj), (tp, n_p), (ts, _)) in enumerate(zip(outs_j, outs_p, solo)):
        np.testing.assert_array_equal(tp, np.asarray(tj), err_msg=f"row {i}")
        np.testing.assert_array_equal(ts, tp, err_msg=f"row {i} solo")
        assert n_p == nj
