"""``mars5_tts_torch.train`` and the VB half of its diffusion against the JAX
package's ``train.py`` / ``diffusion/multinomial.py`` and optax, on tiny
models carried across with the reference-layout converters (JAX gradient
trees go through the same converters, which only move layouts).

Tolerances: losses rtol 1e-5; gradients atol 1e-5 + rtol 1e-4; the
optimizer against optax rtol 1e-6 (both f32, one update's rounding)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mars5_tts_torch import train as PT
from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion as PDiff
from mars5_tts_torch.diffusion.multinomial import index_to_log_onehot as p_onehot
from mars5_tts_torch.models.ar import CodecLMConfig as PARCfg
from mars5_tts_torch.models.convert import (codeclm_port_state_dict, codeclm_reference_state_dict,
                                            load_codeclm, load_nar, nar_reference_state_dict)
from mars5_tts_torch.models.nar import ResidualTransformerConfig as PNCfg
from mars5_tts_tpu import train as JT
from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
from mars5_tts_tpu.diffusion.multinomial import index_to_log_onehot as j_onehot
from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm
from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar

T_STEPS = 8
K = 1025


@pytest.fixture(scope="module")
def tiny():
    ar_cfg = CodecLMConfig.tiny(n_vocab=64)
    nar_cfg = ResidualTransformerConfig.tiny(n_text_vocab=16)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (ar_cfg, nar_cfg, to_np(init_codeclm(jax.random.PRNGKey(0), ar_cfg)),
            to_np(init_nar(jax.random.PRNGKey(1), nar_cfg)))


def _pcfgs(ar_cfg, nar_cfg):
    return (PARCfg(**dataclasses.asdict(ar_cfg)), PNCfg(**dataclasses.asdict(nar_cfg)))


def _port_models(tiny, remat=None):
    ar_cfg, nar_cfg, ar_p, nar_p = tiny
    pa, pn = _pcfgs(ar_cfg, nar_cfg)
    return (load_codeclm(codeclm_reference_state_dict(ar_p, pa), pa, trainable=True, remat=remat),
            load_nar(nar_reference_state_dict(nar_p, pn), pn, trainable=True, remat=remat))


def _batches(seed=0, bs=3):
    """An AR batch with a ragged loss mask and a NAR batch with padded
    frames, texts and speaker codes."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (bs, 12)).astype(np.int32)
    mask = np.zeros((bs, 11), np.float32)
    for i, (a, b) in enumerate(((2, 11), (4, 9), (0, 6))[:bs]):
        mask[i, a:b] = 1
    spk = rng.integers(0, 1024, (bs, 4, 8)).astype(np.int32)
    spk[1, 3:] = 1024
    ctl = np.array([5, 3, 4][:bs], np.int32)
    ccl = np.array([4, 2, 3][:bs], np.int32)
    c_text = rng.integers(0, 16, (bs, 5)).astype(np.int32)
    c_codes = rng.integers(0, 1024, (bs, 4, 8)).astype(np.int32)
    x0 = rng.integers(0, 1024, (bs, 6, 8)).astype(np.int32)
    xpm = np.zeros((bs, 6), bool)
    xpm[1, 4:] = True
    xpm[2, 5:] = True
    return (tokens, mask, spk), (c_text, c_codes, ctl, ccl, x0, xpm)


def jax_draws(key, x0_shape, p_cond_drop=0.1):
    """The draws JAX's ``nar_loss_fn`` makes from ``key``, as port tensors."""
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (x0_shape[0],), 0, T_STEPS)
    u = jax.random.uniform(k_noise, tuple(x0_shape) + (K,))
    drop = jax.random.bernoulli(k_drop, p_cond_drop, (x0_shape[0],))
    return PT.NarDraws(*(torch.from_numpy(np.array(a)) for a in (t, u, drop)))


def _grads(model, loss):
    params = PT.trainable_params(model)
    return dict(zip(params, (g.numpy() for g in torch.autograd.grad(loss, list(params.values())))))


def _assert_grads(port, want):
    assert set(port) == set(want)
    for n in want:
        np.testing.assert_allclose(port[n], np.asarray(want[n], np.float32), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def _ar_port_tree(tree, ar_cfg):
    pa = PARCfg(**dataclasses.asdict(ar_cfg))
    return codeclm_port_state_dict(codeclm_reference_state_dict(tree, pa), pa)


def _nar_port_tree(tree, nar_cfg):
    return nar_reference_state_dict(tree, PNCfg(**dataclasses.asdict(nar_cfg)))


def test_vb_terms_match_jax():
    """``q_sample``, ``q_posterior``, ``compute_Lt`` (with and without the KL
    prior, t = 0 rows included) and ``kl_prior`` against JAX on shared
    inputs and uniforms."""
    rng = np.random.default_rng(3)
    jd, pd = JDiff(K, timesteps=T_STEPS), PDiff(K, timesteps=T_STEPS)
    x0 = rng.integers(0, K, (4, 5, 8))
    t = np.array([0, 3, 7, 1])
    u = rng.random((4, 5, 8, K)).astype(np.float32)
    logits = rng.standard_normal((4, 5, 8, K)).astype(np.float32)
    jl0, pl0 = j_onehot(jnp.asarray(x0), K), p_onehot(torch.from_numpy(x0), K)
    np.testing.assert_array_equal(pl0.numpy(), np.asarray(jl0))
    jxt = jd.q_sample(jl0, jnp.asarray(t), jnp.asarray(u))
    pxt = pd.q_sample(pl0, torch.from_numpy(t), torch.from_numpy(u))
    np.testing.assert_array_equal(pxt.numpy(), np.asarray(jxt))
    jpred = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    ppred = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    jlxt, plxt = j_onehot(jxt, K), p_onehot(pxt, K)
    np.testing.assert_allclose(pd.q_posterior(pl0, plxt, torch.from_numpy(t)).numpy(),
                               np.asarray(jd.q_posterior(jl0, jlxt, jnp.asarray(t))),
                               rtol=1e-5, atol=1e-5)
    for prior in (True, False):
        want = np.asarray(jd.compute_Lt(jl0, jlxt, jpred, jnp.asarray(t), include_kl_prior=prior))
        got = pd.compute_Lt(pl0, plxt, ppred, torch.from_numpy(t), include_kl_prior=prior)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(pd.kl_prior(pl0).numpy(), np.asarray(jd.kl_prior(jl0)), rtol=1e-5)


def test_ar_loss_and_grads_match_jax(tiny):
    ar_cfg, nar_cfg, ar_p, _ = tiny
    ar, _ = _port_models(tiny)
    (tokens, mask, spk), _ = _batches()
    jl, jg = jax.jit(jax.value_and_grad(JT.ar_loss_fn), static_argnums=1)(jax.tree.map(jnp.asarray, ar_p), ar_cfg,
                                                jnp.asarray(tokens), jnp.asarray(mask),
                                                jnp.asarray(spk))
    b = PT.to_batch((tokens, mask, spk), PT.AR_DTYPES, "cpu")
    pl = PT.ar_loss_fn(ar, *b)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _assert_grads(_grads(ar, pl), _ar_port_tree(jax.tree.map(np.asarray, jg), ar_cfg))


def test_nar_loss_and_grads_match_jax(tiny):
    """JAX's t, u and drop injected (a drop row included)."""
    ar_cfg, nar_cfg, _, nar_p = tiny
    _, nar = _port_models(tiny)
    _, nb = _batches()
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, nb[4].shape, p_cond_drop=0.5)
    assert draws.drop.any() and not draws.drop.all()
    jd = JDiff(nar_cfg.n_quant, timesteps=T_STEPS)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.nar_loss_fn(p, nar_cfg, jd, tuple(map(jnp.asarray, nb)), key, 0.5)))(
            jax.tree.map(jnp.asarray, nar_p))
    pl = PT.nar_loss_fn(nar, PDiff(K, timesteps=T_STEPS),
                        PT.to_batch(nb, PT.NAR_DTYPES, "cpu"), draws)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _assert_grads(_grads(nar, pl), _nar_port_tree(jax.tree.map(np.asarray, jg), nar_cfg))


def test_train_step_matches_jax(tiny):
    """One combined step (AdamW, clip 1.0) from the same parameters and
    draws: both losses, and every parameter after the step within 2e-5 of
    JAX's (Adam's first update is lr * g / (|g| + eps) ~ lr sign(g), so a
    gradient entry near 0 moves by up to its own rounding over eps)."""
    ar_cfg, nar_cfg, ar_p, nar_p = tiny
    ar, nar = _port_models(tiny)
    ab, nb = _batches(1)
    key = jax.random.PRNGKey(5)
    jopt = JT.make_optimizer(1e-3, clip_norm=1.0)
    jstate = JT.init_train_state(jax.tree.map(jnp.asarray, ar_p),
                                 jax.tree.map(jnp.asarray, nar_p), jopt)
    jd = JDiff(nar_cfg.n_quant, timesteps=T_STEPS)
    jstate, jm = jax.jit(JT.make_train_step(ar_cfg, nar_cfg, jd, jopt))(
        jstate, tuple(map(jnp.asarray, ab)), tuple(map(jnp.asarray, nb)), key)
    popt = PT.make_optimizer(1e-3, clip_norm=1.0)
    pstate = PT.init_train_state(ar, nar, popt)
    pstate, pm = PT.make_train_step(PDiff(K, timesteps=T_STEPS), popt)(
        pstate, ab, nb, draws=jax_draws(key, nb[4].shape))
    assert pstate.step == int(jstate.step) == 1
    for name in ("ar_loss", "nar_loss"):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-5)
    for model, tree in ((ar, _ar_port_tree(jax.tree.map(np.asarray, jstate.ar_params), ar_cfg)),
                        (nar, _nar_port_tree(jax.tree.map(np.asarray, jstate.nar_params),
                                             nar_cfg))):
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), tree[n], atol=2e-5, rtol=0,
                                       err_msg=n)


def _optax_run(opt, params, grad_seq):
    state = opt.init(params)
    out = []
    for g in grad_seq:
        upd, state = opt.update(g, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        out.append(jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, clip_norm=0.5),
    dict(lr=1e-2, warmup_steps=2, total_steps=7, clip_norm=1.0),
    dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0, accum_steps=2),
    dict(lr=1e-2, weight_decay=0.3, accum_steps=3),
])
@pytest.mark.parametrize("chunk", [None, 5])
def test_optimizer_reproduces_optax(kw, chunk, monkeypatch):
    """Clip, warmup-cosine schedule and MultiSteps against optax on a
    parameter dict and a stream of gradients (some above the clip norm):
    parameters after every call within rtol 1e-6; with accumulation the
    parameters stay bitwise unchanged between applied updates, and with the
    schedule the first applied update runs at warmup lr 0. ``chunk``: the
    foreach passes over chunks of at most that many elements (here each
    tensor a chunk of its own), else the default (one chunk)."""
    if chunk:
        monkeypatch.setattr(PT, "CHUNK_ELEMENTS", chunk)
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.1, 2.0, 0.3, 1.5, 0.05, 0.8, 3.0, 0.2)]
    want = _optax_run(JT.make_optimizer(**kw), jax.tree.map(jnp.asarray, params),
                      [jax.tree.map(jnp.asarray, g) for g in grads])
    opt = PT.make_optimizer(**kw)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(pp)
    prev = {k: v.clone() for k, v in pp.items()}
    k_acc = kw.get("accum_steps", 1)
    for i, (g, w) in enumerate(zip(grads, want)):
        opt.apply(pp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        for k in pp:
            np.testing.assert_allclose(pp[k].numpy(), w[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"call {i} {k}")
        applied = (i + 1) % k_acc == 0
        if not applied:
            assert all(torch.equal(pp[k], prev[k]) for k in pp)
        elif kw.get("total_steps") and i + 1 == k_acc:
            assert all(torch.equal(pp[k], prev[k]) for k in pp)      # lr 0 at count 0
        else:
            assert not any(torch.equal(pp[k], prev[k]) for k in pp)
        prev = {k: v.clone() for k, v in pp.items()}
    assert st.gradient_step == (len(grads) // k_acc if k_acc > 1 else 0)


def test_remat_gives_the_same_losses_and_grads(tiny):
    """Per-layer rematerialization (``remat=True``, here through the loaders) recomputes
    the same forward: losses and gradients bitwise those without it; the
    default follows ``MARS5_TRAIN_REMAT``."""
    _, nb = _batches()
    ab, _ = _batches()
    draws = jax_draws(jax.random.PRNGKey(2), nb[4].shape, 0.5)
    diff = PDiff(K, timesteps=T_STEPS)
    out = {}
    for remat in (False, True):
        ar, nar = _port_models(tiny, remat)
        assert all(m.remat == remat for m in (ar.ar, nar.tfm.encoder, nar.spk_encoder))
        al = PT.ar_loss_fn(ar, *PT.to_batch(ab, PT.AR_DTYPES, "cpu"))
        nl = PT.nar_loss_fn(nar, diff, PT.to_batch(nb, PT.NAR_DTYPES, "cpu"), draws)
        out[remat] = (al.detach(), nl.detach(), _grads(ar, al), _grads(nar, nl))
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])
    for i in (2, 3):
        for n, g in out[False][i].items():
            np.testing.assert_array_equal(out[True][i][n], g, err_msg=n)


def test_remat_default_from_env(monkeypatch):
    from mars5_tts_torch.models.ar import CodecLM
    from mars5_tts_torch.models.nar import ResidualTransformer

    monkeypatch.setenv("MARS5_TRAIN_REMAT", "1")
    stacks = [m for m in (CodecLM(PARCfg.tiny()), ResidualTransformer(PNCfg.tiny()))
              for m in m.modules() if hasattr(m, "remat")]
    assert len(stacks) == 5 and all(m.remat for m in stacks)
    monkeypatch.setenv("MARS5_TRAIN_REMAT", "0")
    assert not CodecLM(PARCfg.tiny()).ar.remat
    assert CodecLM(PARCfg.tiny(), remat=True).spk_encoder.remat


def _run(state, step, batches, n):
    losses = []
    for i in range(n):
        state, m = step(state, *batches[i % len(batches)])
        losses.append((float(m["ar_loss"]), float(m["nar_loss"])))
    return losses


def test_resume_is_bitwise_the_uninterrupted_run(tiny, tmp_path):
    """Four steps straight against two, a save, a restore into a fresh state
    of other weights, and two more: the same losses, parameters, moments,
    counts and accumulation buffers, bit for bit (accumulation, schedule
    and clip on; the NAR draws from the state's generator)."""
    opt = PT.make_optimizer(1e-3, warmup_steps=1, total_steps=6, clip_norm=1.0, accum_steps=2)
    step = PT.make_train_step(PDiff(K, timesteps=T_STEPS), opt, p_cond_drop=0.5)
    batches = [_batches(0), _batches(1)]

    def fresh(seed):
        ar, nar = _port_models(tiny)
        if seed:
            with torch.no_grad():
                for p in list(ar.parameters()) + list(nar.parameters()):
                    p.add_(0.01)
        return PT.init_train_state(ar, nar, opt, seed=seed)

    a = fresh(0)
    straight = _run(a, step, batches, 4)
    b = fresh(0)
    first = _run(b, step, batches, 2)
    PT.save_train_checkpoint(tmp_path / "ckpt.pt", b)
    c = PT.restore_train_checkpoint(tmp_path / "ckpt.pt", fresh(9))
    assert c.step == 2 and c.ar_opt.mini_step == 0 and c.ar_opt.count == 1
    rest = _run(c, step, batches, 2)
    assert first + rest == straight
    for x, y in ((a.ar, c.ar), (a.nar, c.nar)):
        for (n, p), (_, q) in zip(x.named_parameters(), y.named_parameters()):
            assert torch.equal(p, q), n
    for x, y in ((a.ar_opt, c.ar_opt), (a.nar_opt, c.nar_opt)):
        for tree in ("mu", "nu", "acc"):
            for n, t in getattr(x, tree).items():
                assert torch.equal(t, getattr(y, tree)[n]), (tree, n)
        assert (x.count, x.sched_count, x.mini_step, x.gradient_step) == (
            y.count, y.sched_count, y.mini_step, y.gradient_step)
    assert torch.equal(a.generator.get_state(), c.generator.get_state())


def test_trainable_loader_leaves_inference_loaders_frozen(tiny):
    ar_cfg, nar_cfg, ar_p, nar_p = tiny
    pa, pn = _pcfgs(ar_cfg, nar_cfg)
    frozen = load_nar(nar_reference_state_dict(nar_p, pn), pn)
    assert not any(p.requires_grad for p in frozen.parameters()) and not frozen.training
    ar, nar = _port_models(tiny)
    assert all(p.requires_grad for p in list(ar.parameters()) + list(nar.parameters()))
    assert ar.training and nar.training
