"""``mars5_tts_torch.parallel``, the sharded train step and
``serving/multichip.py`` in several processes: ``torch.distributed`` on gloo
over the CPU, spawned by ``parallel.launch.spawn_ranks`` (a ``file://``
rendezvous in a temporary directory of its own, so parallel test workers
never share a port), at world sizes 2 (dp 2, or tp 2) and 4 (dp 2 x tp 2,
or tp 4). Each test bounds its processes by its own timeout.

Tolerances: the tp-sharded loss rtol 1e-5 of the single-process loss and of
JAX's, gradients and logits atol 1e-5 + rtol 1e-4 (row-parallel products sum
in another split); data-parallel decoding and diffusion bitwise;
tensor-parallel decoding in f32 token for token and cell for cell (the
row-parallel sums part from one process's in the last bits only, and no
sampled logit at these sizes is that close to a tie)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mars5_tts_torch.parallel.launch import spawn_ranks

K = 1025
T_STEPS = 6


# --- tiny models (built by the JAX package, carried across) -------------------

def _ar_cfg():
    from mars5_tts_tpu.models.ar import CodecLMConfig

    return CodecLMConfig(n_vocab=64, dim=64, n_heads=4, n_kv_heads=4, head_dim=16,
                         n_layers=2, hidden_dim=96, sliding_window=32, n_spk_layers=2,
                         spk_hidden_dim=192)


def _models():
    """(ar jax cfg, ar params, ar reference state dict, nar jax cfg, nar params,
    nar reference state dict)."""
    import jax

    from mars5_tts_tpu.models.ar import init_codeclm
    from mars5_tts_tpu.models.nar import ResidualTransformerConfig, init_nar
    from mars5_tts_torch.models.ar import CodecLMConfig as PA
    from mars5_tts_torch.models.convert import (codeclm_reference_state_dict,
                                                nar_reference_state_dict)
    from mars5_tts_torch.models.nar import ResidualTransformerConfig as PN

    ar_cfg, nar_cfg = _ar_cfg(), ResidualTransformerConfig.tiny(n_text_vocab=32)
    ar_p = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(0), ar_cfg))
    nar_p = jax.tree.map(np.asarray, init_nar(jax.random.PRNGKey(1), nar_cfg))
    pa, pn = PA(**dataclasses.asdict(ar_cfg)), PN(**dataclasses.asdict(nar_cfg))
    return (ar_cfg, ar_p, (codeclm_reference_state_dict(ar_p, pa), pa),
            nar_cfg, nar_p, (nar_reference_state_dict(nar_p, pn), pn))


def _port(sd_cfg, kind, trainable=True):
    from mars5_tts_torch.models.convert import load_codeclm, load_nar

    return (load_codeclm if kind == "ar" else load_nar)(*sd_cfg, trainable=trainable)


def _batches(bs=4):
    """An AR batch whose loss masks differ across the dp halves (rows 0-1 on
    dp rank 0, 2-3 on rank 1) and a NAR batch with padded frames."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (bs, 12)).astype(np.int32)
    mask = np.zeros((bs, 11), np.float32)
    for i, (a, b) in enumerate(((0, 11), (3, 11), (5, 7), (1, 4))):
        mask[i, a:b] = 1
    spk = rng.integers(0, 1024, (bs, 5, 8)).astype(np.int32)
    spk[2, 3:] = 1024
    nar = (rng.integers(0, 32, (bs, 5)).astype(np.int32),
           rng.integers(0, 1024, (bs, 4, 8)).astype(np.int32),
           np.array([5, 3, 4, 2], np.int32), np.array([4, 2, 3, 4], np.int32),
           rng.integers(0, 1024, (bs, 7, 8)).astype(np.int32), np.zeros((bs, 7), bool))
    nar[5][1, 5:] = True
    return (tokens, mask, spk), nar


def _nar_fwd_args(nar_batch, t):
    from mars5_tts_torch.train import NAR_DTYPES, to_batch

    c_text, c_codes, ctl, ccl, x0, xpm = to_batch(nar_batch, NAR_DTYPES, "cpu")
    return c_text, c_codes, ctl, ccl, x0, xpm, torch.as_tensor(t)


# --- the mesh and the placements ------------------------------------------------

def _mesh_worker(rank, world, nar_sd):
    from mars5_tts_torch.ops.attention import _thirds
    from mars5_tts_torch.parallel import make_mesh, nar_specs, replicated, shard_tree

    out = {}
    mesh = make_mesh(dp=2, tp=2)
    out["shape"] = (tuple(mesh.shape), mesh.mesh_dim_names)
    out["replicated"] = replicated(mesh)
    for kw in (dict(dp=3, tp=2), dict(tp=3)):
        try:
            make_mesh(**kw)
            out[str(kw)] = None
        except ValueError as e:
            out[str(kw)] = str(e)
    nar = shard_tree(mesh, _port(nar_sd, "nar"), nar_specs(_port(nar_sd, "nar"), 2))
    layer = nar.tfm.decoder.layers[0]
    out["coord"] = mesh.get_coordinate()
    out["in_proj"] = layer.self_attn.in_proj_weight.to_local().detach().clone()
    out["in_bias"] = layer.self_attn.in_proj_bias.to_local().detach().clone()
    thirds = _thirds(layer.self_attn.in_proj_weight)
    out["thirds"] = [(t.placements, t.full_tensor().detach().clone()) for t in thirds]
    out["W"] = layer.activation.W.weight.to_local().shape
    out["lin2"] = layer.linear2.weight.to_local().shape
    return out


def test_mesh_and_specs():
    """``make_mesh`` (shape, names, the divisibility errors), the placement
    trees (column, row, vocabulary, the tp = 7 fallback to replication,
    JAX's ``test_mesh_and_specs``), and the NAR's in-projection placed
    head-aligned a third at a time: each tp rank holds the same heads of q,
    k and v, and ``ops.attention._thirds`` gives q, k and v back whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    from mars5_tts_torch.parallel import codeclm_specs, nar_specs

    ar_cfg, _, ar_sd, _, _, nar_sd = _models()
    ar = _port(ar_sd, "ar")
    specs = codeclm_specs(ar, tp_size=4)
    assert specs["ar.layers.0.attention.wq.weight"] == Shard(0)       # 4 heads x 16 / 4
    assert specs["ar.layers.1.attention.wo.weight"] == Shard(1)
    assert specs["ar.layers.0.feed_forward.w2.weight"] == Shard(1)
    assert specs["ar.output.weight"] == Shard(0) and specs["embed.weight"] == Shard(0)
    assert specs["ar.norm.weight"] == Replicate()
    assert specs["spk_encoder.layers.0.self_attn.in_proj_weight"] == Replicate()
    specs7 = codeclm_specs(ar, tp_size=7)
    assert all(p == Replicate() for p in specs7.values())
    ns = nar_specs(_port(nar_sd, "nar"), tp_size=4)
    for stack in ("tfm.encoder", "tfm.decoder", "spk_encoder"):
        assert ns[f"{stack}.layers.1.self_attn.in_proj_weight"] == _StridedShard(0, split_factor=3)
        assert ns[f"{stack}.layers.1.self_attn.out_proj.weight"] == Shard(1)
        assert ns[f"{stack}.layers.1.activation.V.weight"] == Shard(0)
        assert ns[f"{stack}.layers.1.linear2.weight"] == Shard(1)
    assert ns["tfm.decoder.layers.0.multihead_attn.in_proj_bias"] == _StridedShard(0, split_factor=3)
    assert ns["residual_decoder.0.1.weight"] == Replicate()
    assert all(p == Replicate() for p in nar_specs(_port(nar_sd, "nar"), tp_size=7).values())

    outs = spawn_ranks(_mesh_worker, 4, nar_sd, timeout=120)
    w = nar_sd[0]["tfm.decoder.layers.0.self_attn.in_proj_weight"]
    b = nar_sd[0]["tfm.decoder.layers.0.self_attn.in_proj_bias"]
    for out in outs:
        assert out["shape"] == ((2, 2), ("dp", "tp"))
        assert out["replicated"] == (Replicate(), Replicate())
        assert "dp*tp = 6 != 4" in out[str(dict(dp=3, tp=2))]
        assert "not divisible by tp=3" in out[str(dict(tp=3))]
        r = out["coord"][1]
        rows = np.concatenate([np.arange(i * 64 + r * 32, i * 64 + (r + 1) * 32) for i in range(3)])
        np.testing.assert_array_equal(out["in_proj"].numpy(), w[rows])
        np.testing.assert_array_equal(out["in_bias"].numpy(), b[rows])
        for i, (placements, third) in enumerate(out["thirds"]):
            assert placements == (Replicate(), Shard(0))
            np.testing.assert_array_equal(third.numpy(), w[i * 64:(i + 1) * 64])
        assert tuple(out["W"]) == (96, 64) and tuple(out["lin2"]) == (64, 96)


def test_make_mesh_on_gloo_is_a_host_mesh(tmp_path, monkeypatch):
    """A gloo group's mesh is a CPU mesh even where PyTorch sees a card
    (gloo's collectives take host tensors; a CUDA mesh over gloo put the
    shards on the card)."""
    from mars5_tts_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(dp=1, tp=1)
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("dp", "tp")
    finally:
        dist.destroy_process_group()


# --- the sharded training loss, gradients and step ---------------------------------

def _step_draws(diff, nar_batch):
    from mars5_tts_torch import train as PT

    return PT.nar_draws(diff, nar_batch[4].shape, torch.Generator().manual_seed(4), 0.5)


def _train_worker(rank, world, ar_sd, nar_sd, batches, t):
    from torch.distributed.tensor.experimental import implicit_replication

    from mars5_tts_torch import train as PT
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.parallel import codeclm_specs, make_mesh, nar_specs, shard_tree

    mesh = make_mesh(dp=2, tp=2)
    ab, nb = batches
    out = {}
    ar = shard_tree(mesh, _port(ar_sd, "ar"), codeclm_specs(_port(ar_sd, "ar"), 2))
    with implicit_replication():
        loss = PT.ar_loss_fn(ar, *PT.to_batch(ab, PT.AR_DTYPES, "cpu", mesh))
        params = PT.trainable_params(ar)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["ar_loss"] = loss.detach().full_tensor()
        out["ar_grads"] = {n: PT._full(g) for n, g in zip(params, grads)}
        out["ar_placements"] = {n: p.placements for n, p in params.items()}
    nar = shard_tree(mesh, _port(nar_sd, "nar"), nar_specs(_port(nar_sd, "nar"), 2))
    args = _nar_fwd_args(nb, t)
    with torch.no_grad(), implicit_replication():
        out["nar_logits"] = nar(*args).full_tensor()

    # one sharded step against the single-process step (the same draws), and
    # the NAR gradients it takes
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    draws = _step_draws(diff, nb)
    with implicit_replication():
        params = PT.trainable_params(nar)
        on_dp = PT.NarDraws(*(PT._on_dp(mesh, x) for x in (draws.t, draws.u, draws.drop)))
        loss = PT.nar_loss_fn(nar, diff, PT.to_batch(nb, PT.NAR_DTYPES, "cpu", mesh), on_dp)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["nar_grads"] = {n: PT._full(g) for n, g in zip(params, grads)}
    opt = PT.make_optimizer(1e-3, clip_norm=1.0)
    state = PT.init_train_state(_port(ar_sd, "ar"), _port(nar_sd, "nar"), opt, seed=4)
    state = PT.shard_train_state(mesh, state, codeclm_specs(state.ar, 2),
                                 nar_specs(state.nar, 2))
    moment = state.nar_opt.mu["tfm.decoder.layers.0.self_attn.in_proj_weight"]
    out["moment_follows"] = moment.placements == state.nar.tfm.decoder.layers[0].self_attn \
        .in_proj_weight.placements
    state, m = PT.make_train_step(diff, opt)(state, ab, nb, draws)
    out["step_losses"] = (float(m["ar_loss"]), float(m["nar_loss"]))
    out["step_params"] = {n: PT._full(p.detach())
                          for model in (state.ar, state.nar)
                          for n, p in ((f"{type(model).__name__}.{k}", v)
                                       for k, v in model.named_parameters())}
    return out


def test_dp_tp_sharded_training_matches_single_process_and_jax():
    """dp 2 x tp 2: the AR loss over a batch whose masks differ across the
    dp halves is the global ``sum(nll mask) / sum(mask)``, equal to the
    single-process loss and JAX's, with the same gradients; the NAR's TP
    logits equal the replicated ones and its sharded gradients the
    single-process ones; one sharded train step (AdamW, clip) gives the
    single-process step's losses and parameters, and the Adam moments
    follow their parameters' placements."""
    import jax
    import jax.numpy as jnp
    from torch.distributed.tensor import Replicate, Shard

    from mars5_tts_torch import train as PT
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.convert import codeclm_port_state_dict, codeclm_reference_state_dict
    from mars5_tts_tpu.train import ar_loss_fn

    ar_cfg, ar_p, ar_sd, nar_cfg, nar_p, nar_sd = _models()
    ab, nb = _batches()
    t = np.array([0, 3, 5, 1])
    outs = spawn_ranks(_train_worker, 4, ar_sd, nar_sd, (ab, nb), t, timeout=300)

    ar = _port(ar_sd, "ar")
    loss = PT.ar_loss_fn(ar, *PT.to_batch(ab, PT.AR_DTYPES, "cpu"))
    params = PT.trainable_params(ar)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jl, jg = jax.jit(jax.value_and_grad(ar_loss_fn), static_argnums=1)(
        jax.tree.map(jnp.asarray, ar_p), ar_cfg, *map(jnp.asarray, ab))
    jg = codeclm_port_state_dict(codeclm_reference_state_dict(jax.tree.map(np.asarray, jg),
                                                              ar_sd[1]), ar_sd[1])
    per_rank_mean = np.mean([float(PT.ar_loss_fn(ar, *PT.to_batch(tuple(x[h] for x in ab),
                                                                  PT.AR_DTYPES, "cpu")).detach())
                             for h in (slice(0, 2), slice(2, 4))])
    assert abs(per_rank_mean - float(loss)) > 1e-3      # a DDP-style mean would differ
    nar = _port(nar_sd, "nar")
    with torch.no_grad():
        logits = nar(*_nar_fwd_args(nb, t))
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    opt = PT.make_optimizer(1e-3, clip_norm=1.0)
    state = PT.init_train_state(_port(ar_sd, "ar"), _port(nar_sd, "nar"), opt, seed=4)
    state, m = PT.make_train_step(diff, opt)(state, ab, nb, _step_draws(diff, nb))
    nar = _port(nar_sd, "nar")
    params = PT.trainable_params(nar)
    nar_loss = PT.nar_loss_fn(nar, diff, PT.to_batch(nb, PT.NAR_DTYPES, "cpu"),
                              _step_draws(diff, nb))
    ref_grads = {n: g.numpy() for n, g in
                 zip(params, torch.autograd.grad(nar_loss, list(params.values())))}
    for out in outs:
        np.testing.assert_allclose(float(out["ar_loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(out["ar_loss"]), float(jl), rtol=1e-5)
        for n, g in grads.items():
            np.testing.assert_allclose(out["ar_grads"][n].numpy(), g.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=n)
            np.testing.assert_allclose(out["ar_grads"][n].numpy(), jg[n], atol=1e-5,
                                       rtol=1e-4, err_msg=n)
        assert out["ar_placements"]["ar.layers.0.attention.wq.weight"] == (Replicate(), Shard(0))
        np.testing.assert_allclose(out["nar_logits"].numpy(), logits.numpy(), atol=1e-5,
                                   rtol=1e-4)
        assert out["moment_follows"]
        np.testing.assert_allclose(out["step_losses"], (float(m["ar_loss"]),
                                                        float(m["nar_loss"])), rtol=1e-5)
        for n, g in ref_grads.items():
            np.testing.assert_allclose(out["nar_grads"][n].numpy(), g, atol=1e-5, rtol=1e-4,
                                       err_msg=n)
        for model in (state.ar, state.nar):
            for n, p in model.named_parameters():
                np.testing.assert_allclose(out["step_params"][f"{type(model).__name__}.{n}"],
                                           p.detach().numpy(), atol=2e-5, rtol=0, err_msg=n)


# --- data-parallel serving -----------------------------------------------------------

def _ar_sampling():
    from mars5_tts_torch.models.ar_decode import ArSampling

    return ArSampling(temperature=0.7, top_k=10, top_p=0.9, typical_p=1.0,
                      alpha_frequency=1.0, alpha_presence=0.4, penalty_window=5,
                      eos_penalty_decay=0.5, eos_penalty_factor=1.0, n_phones_gen=8,
                      eos_idx=49, valid_start=20, valid_end=51, max_len=40)


def _serve_inputs():
    rng = np.random.default_rng(0)
    s = _ar_sampling()
    prompts = [rng.integers(0, 20, int(n)) for n in rng.integers(4, 12, 3)]
    spks = [rng.integers(0, 1024, (4, 8)) for _ in range(3)]
    uniforms = [rng.random(s.max_len).astype(np.float32) for _ in range(3)]
    bs, lt, lc, lx = 4, 5, 7, 11
    nar_batch = (rng.integers(0, 32, (bs, lt)), rng.integers(0, 1024, (bs, lc, 8)),
                 np.full((bs,), lt), np.full((bs,), lc), rng.integers(0, 1024, (bs, lx, 8)),
                 np.zeros((bs, lx), bool))
    nar_u = rng.random((T_STEPS, 2, bs, lc + lx, 8, K)).astype(np.float32)
    x_init = rng.integers(0, K, (bs, lx, 8))
    ragged = nar_batch[:3] + (np.array([lc, 4, 5, 4]),) + nar_batch[4:]   # the dp halves differ
    return prompts, spks, uniforms, (nar_batch, ragged), nar_u, x_init


def _dsh(deep):
    from mars5_tts_torch.config import DSH

    return DSH(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, jump_len=1, jump_n_sample=1,
               q0_override_steps=1, deep_clone=deep)


def _serve_worker(rank, world, ar_sd, nar_sd):
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder, ShardedNARDiffusion

    ar, nar = _port(ar_sd, "ar", False), _port(nar_sd, "nar", False)
    mesh = make_mesh(tp=1)
    prompts, spks, uniforms, nb, nu, x_init = _serve_inputs()
    dec = ShardedARDecoder(ar, _ar_sampling(), mesh=mesh)
    out = {"dp": dec.dp,
           "ar_u": dec.generate(prompts, spks, uniforms=uniforms),
           "ar_seeds": dec.generate(prompts[:1], spks[:1], seeds=[5])}
    svc = ShardedNARDiffusion(nar, mesh=mesh)
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    for layout, batch in zip(("", "ragged_"), nb):
        out[layout + "nar_u"] = svc.infer(batch, diff, T_STEPS, _dsh(True), uniforms=nu,
                                          x_init=x_init)
        out[layout + "nar_gen"] = svc.infer(batch, diff, T_STEPS, _dsh(bool(layout)),
                                            generator=torch.Generator().manual_seed(7))
    return out


def test_dp_decoders_bitwise_equal_single_process():
    """dp 2: ``ShardedARDecoder`` over three requests (one pad row) equals
    ``ar_generate_batched`` over all three and each request's solo run,
    token for token, on injected uniforms and on seeded streams;
    ``ShardedNARDiffusion`` equals ``perform_simple_inference`` over the
    whole batch on injected uniforms and on a generator (the draws at the
    whole batch's shape), deep clone at one prompt length and ragged (the
    dp halves' longest prompts differ: the layout is the whole batch's),
    and shallow, bit for bit."""
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.ar_decode import ar_generate, ar_generate_batched

    _, _, ar_sd, _, _, nar_sd = _models()
    outs = spawn_ranks(_serve_worker, 2, ar_sd, nar_sd, timeout=300)
    ar, nar = _port(ar_sd, "ar", False), _port(nar_sd, "nar", False)
    prompts, spks, uniforms, nb, nu, x_init = _serve_inputs()
    s = _ar_sampling()
    want = ar_generate_batched(ar, prompts, spks, sampling=s, uniforms=np.stack(uniforms, 1))
    seeded = ar_generate(ar, prompts[0], spks[0], sampling=s,
                         uniforms=torch.rand(s.max_len, generator=torch.Generator().manual_seed(5)))
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    grids = {}
    for layout, batch in zip(("", "ragged_"), nb):
        grids[layout + "nar_u"] = perform_simple_inference(nar, batch, diff, T_STEPS, _dsh(True),
                                                           uniforms=nu, x_init=x_init)
        grids[layout + "nar_gen"] = perform_simple_inference(
            nar, batch, diff, T_STEPS, _dsh(bool(layout)),
            generator=torch.Generator().manual_seed(7))
    for out in outs:
        assert out["dp"] == 2 and len(out["ar_u"]) == 3
        for (toks, n), (wt, wn), p, k, u in zip(out["ar_u"], want, prompts, spks, uniforms):
            assert n == wn and toks.tolist() == wt.tolist()
            solo, solo_n = ar_generate(ar, p, k, sampling=s, uniforms=u)
            assert n == solo_n and toks.tolist() == solo.tolist()
        assert out["ar_seeds"][0][0].tolist() == seeded[0].tolist()
        for name, grid in grids.items():
            assert torch.equal(out[name], grid), name


# --- tensor-parallel decoding --------------------------------------------------------

def _tp_ar(n_vocab):
    """The JAX TP decode test's AR (``tests/test_multichip.py::
    test_sharded_ar_decode_with_tp``: 4 heads of 16, window 40) at
    ``n_vocab``: (jax cfg, params, the port's state dict and config)."""
    import jax

    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm
    from mars5_tts_torch.models.ar import CodecLMConfig as PA
    from mars5_tts_torch.models.convert import codeclm_reference_state_dict

    cfg = CodecLMConfig(n_vocab=n_vocab, dim=64, n_heads=4, n_kv_heads=4, head_dim=16,
                        n_layers=2, hidden_dim=96, sliding_window=40, n_spk_layers=2,
                        spk_hidden_dim=192)
    params = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(1), cfg))
    pa = PA(**dataclasses.asdict(cfg))
    return cfg, params, (codeclm_reference_state_dict(params, pa), pa)


def _recording(module, name, calls):
    """Wrap ``module.name`` so that each call's arguments go to ``calls``."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)
    setattr(module, name, rec)


def _tp_ar_worker(rank, world, ar_sd, dp, tp):
    from mars5_tts_torch.models import ar_decode
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder

    calls = []
    _recording(ar_decode, "decode_attention", calls)
    prompts, spks, uniforms = _serve_inputs()[:3]
    dec = ShardedARDecoder(_port(ar_sd, "ar", False), _ar_sampling(),
                           mesh=make_mesh(dp=dp, tp=tp))
    m = dec.model
    return {"tokens": dec.generate(prompts, spks, uniforms=uniforms),
            "k7": {(tuple(q.shape), tuple(ck.shape)) for q, ck, *_ in calls},
            "k7_calls": len(calls), "embed": tuple(m.embed.weight.shape),
            "output": tuple(m.ar.output.weight.shape),
            "vocab_collectives": (m.tp is not None, m.ar.tp is not None),
            "row_collectives": (m.ar.layers[0].attention.tp is not None,
                                m.ar.layers[0].feed_forward.tp is not None,
                                m.spk_encoder.layers[0].tp, m.spk_encoder.layers[0].self_attn.tp)}


@pytest.mark.parametrize("dp,tp,n_vocab", [(2, 2, 64), (1, 4, 64), (1, 2, 65)],
                         ids=["dp2_tp2_vocab64", "dp1_tp4_vocab64", "dp1_tp2_vocab65"])
def test_tp_ar_decoder_equals_single_process_and_jax(dp, tp, n_vocab):
    """``ShardedARDecoder`` at tp > 1 (heads, FFN and, where it divides,
    the vocabulary sharded; ``parallel/tp.py``): three requests on injected
    uniforms give, on every rank, the tokens of ``ar_generate_batched`` in
    one process and of JAX's ``ar_generate`` (whose own dp 2 x tp 4 run
    equals its single-device one, ``tests/test_multichip.py``). Each rank's
    decode attention takes its own heads of q and of the rings (K7's route
    on the card), 2 layers a step; a vocabulary of 65 stays whole at tp 2
    (``_maybe``) and takes no vocabulary collective; the AR's speaker
    encoder stays replicated."""
    from mars5_tts_tpu.models.ar_decode import ArSampling as JSampling, ar_generate as j_generate
    from mars5_tts_torch.models.ar_decode import ar_generate_batched

    cfg, params, ar_sd = _tp_ar(n_vocab)
    outs = spawn_ranks(_tp_ar_worker, dp * tp, ar_sd, dp, tp, timeout=300)
    prompts, spks, uniforms = _serve_inputs()[:3]
    s = _ar_sampling()
    want = ar_generate_batched(_port(ar_sd, "ar", False), prompts, spks, sampling=s,
                               uniforms=np.stack(uniforms, 1))
    js = JSampling(**dataclasses.asdict(s))
    jax_want = [j_generate(params, cfg, p, k, sampling=js, uniforms=u)
                for p, k, u in zip(prompts, spks, uniforms)]
    rows, heads, window = -(-len(prompts) // dp), 4 // tp, min(40, s.max_len + 1)
    sharded = n_vocab % tp == 0
    v = n_vocab // tp if sharded else n_vocab
    for out in outs:
        for (toks, n), (wt, wn), (jt, jn) in zip(out["tokens"], want, jax_want, strict=True):
            assert n == wn == int(jn)
            assert toks.tolist() == wt.tolist() == np.asarray(jt).tolist()
        assert out["k7"] == {((rows, heads, 16), (rows, window, heads, 16))}
        assert out["k7_calls"] > 0 and out["k7_calls"] % 2 == 0
        assert out["embed"] == (v, 64) and out["output"] == (v, 64)
        assert out["vocab_collectives"] == (sharded, sharded)
        assert out["row_collectives"] == (True, True, None, None)


def _tp_nar_worker(rank, world, nar_sd, dp, tp):
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedNARDiffusion

    _, _, _, nb, nu, x_init = _serve_inputs()
    svc = ShardedNARDiffusion(_port(nar_sd, "nar", False), mesh=make_mesh(dp=dp, tp=tp))
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    layer = svc.model.tfm.decoder.layers[0]
    out = {"local": (tuple(layer.self_attn.in_proj_weight.shape),
                     tuple(layer.multihead_attn.out_proj.weight.shape),
                     tuple(layer.activation.W.weight.shape), tuple(layer.linear2.weight.shape),
                     tuple(svc.model.residual_decoder[0][1].weight.shape))}
    for layout, batch in zip(("", "ragged_"), nb):
        out[layout + "grid"] = svc.infer(batch, diff, T_STEPS, _dsh(True), uniforms=nu,
                                         x_init=x_init)
    return out


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)], ids=["dp1_tp2", "dp2_tp2"])
def test_tp_nar_diffusion_equals_single_process_and_jax(dp, tp):
    """``ShardedNARDiffusion`` at tp 2 (each attention's heads a third at a
    time, out_proj and linear2 row-parallel with their biases added once,
    the SwiGLU column-parallel; heads and embeddings replicated): the deep
    clone grid at one prompt length and ragged, on injected uniforms and
    ``x_init``, equals one process's and JAX's ``perform_simple_inference``
    cell for cell, on every rank."""
    from mars5_tts_tpu.config import DSH as JDSH
    from mars5_tts_tpu.diffusion import MultinomialDiffusion as JDiff
    from mars5_tts_tpu.diffusion import perform_simple_inference as j_infer
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion

    _, _, _, nar_cfg, nar_p, nar_sd = _models()
    outs = spawn_ranks(_tp_nar_worker, dp * tp, nar_sd, dp, tp, timeout=300)
    _, _, _, nb, nu, x_init = _serve_inputs()
    nar = _port(nar_sd, "nar", False)
    diff = MultinomialDiffusion(K, timesteps=T_STEPS)
    jdsh = JDSH(**dataclasses.asdict(_dsh(True)))
    for layout, batch in zip(("", "ragged_"), nb):
        want = perform_simple_inference(nar, batch, diff, T_STEPS, _dsh(True), uniforms=nu,
                                        x_init=x_init)
        jax_want = np.asarray(j_infer(nar_p, nar_cfg, batch, JDiff(K, T_STEPS), T_STEPS, jdsh,
                                      uniforms=nu, x_init=x_init))
        np.testing.assert_array_equal(want.numpy(), jax_want)
        for out in outs:
            assert torch.equal(out[layout + "grid"], want), layout
    for out in outs:
        assert out["local"] == ((3 * 64 // tp, 64), (64, 64 // tp), (192 // tp, 64),
                                (64, 192 // tp), (K, 64))


def _hd64_models():
    """A port AR and NAR with head dim 64 (the kernels' only one), two heads
    each, seeded."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig

    ar = CodecLM(CodecLMConfig(n_vocab=64, dim=128, n_heads=2, n_kv_heads=2, head_dim=64,
                               n_layers=2, hidden_dim=96, sliding_window=40, n_spk_layers=1,
                               spk_hidden_dim=96)).init_(torch.Generator().manual_seed(0))
    nar = ResidualTransformer(ResidualTransformerConfig(
        n_text_vocab=32, dim=128, nhead=2, enc_layers=1, dec_layers=2, n_spk_layers=1,
        t_emb_dim=64, hidden_dim=96)).init_(torch.Generator().manual_seed(1))
    return ar.requires_grad_(False), nar.requires_grad_(False)


def _long_nar_batch():
    """One deep-clone row whose decoder runs over 520 frames (K1's route
    from 512)."""
    rng = np.random.default_rng(5)
    lc, lx = 8, 512
    return (rng.integers(0, 32, (1, 5)), rng.integers(0, 1024, (1, lc, 8)), np.array([5]),
            np.array([lc]), rng.integers(0, 1024, (1, lx, 8)), np.zeros((1, lx), bool))


def _tp_route_worker(rank, world):
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models import ar_decode
    from mars5_tts_torch.ops import attention
    from mars5_tts_torch.ops.kernels import decode_attention as A, mha as M
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder, ShardedNARDiffusion

    attention.kernel_route = lambda t: True    # K1's route; its CPU wrapper runs the twin
    ar, nar = _hd64_models()
    mesh = make_mesh(dp=1, tp=2)
    dec, svc = ShardedARDecoder(ar, _ar_sampling(), mesh=mesh), ShardedNARDiffusion(nar, mesh=mesh)
    k1, k7 = [], []
    _recording(attention.mha_kernel, "mha", k1)
    _recording(ar_decode, "decode_attention", k7)
    prompts, spks, uniforms = _serve_inputs()[:3]
    tokens = dec.generate(prompts[:1], spks[:1], uniforms=uniforms[:1])
    grid = svc.infer(_long_nar_batch(), MultinomialDiffusion(K, timesteps=3), 3, _dsh(True),
                     generator=torch.Generator().manual_seed(3))
    for q, ck, cv, pos, kn, vn in k7:
        A.launch_args(q, ck, cv, pos, kn, vn)       # raises on what K7 does not take
    for q, k, v, mask in k1:
        M.launch_args(q, k, v, mask)                # views K1 could not read in place raise
    return {"tokens": tokens, "grid": grid, "k7": {tuple(a[0].shape) for a in k7},
            "k7_calls": len(k7), "k1": {tuple(a[0].shape) for a in k1}, "k1_calls": len(k1),
            "k1_strided": all(not a[0].is_contiguous() for a in k1)}


def test_tp_ranks_attend_on_their_own_heads_through_k7_and_k1(monkeypatch):
    """At tp 2 with attention on the kernels' route (forced here; the CPU
    wrappers run their twins): each rank's AR decode attention gets its one
    head of 64 and its rings (K7: 2 layers a decode step), and the NAR's
    self-attention over 520 frames its head as strided views of its own
    (1, 520, 3 x 64) in-projection (K1: 2 decoder layers a reverse step),
    every call one ``launch_args`` accepts, that is, one the kernel reads
    in place on the card. Tokens and grid equal one process's on the same
    route."""
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.ar_decode import ar_generate
    from mars5_tts_torch.ops import attention

    outs = spawn_ranks(_tp_route_worker, 2, timeout=300)
    monkeypatch.setattr(attention, "kernel_route", lambda t: True)
    ar, nar = _hd64_models()
    prompts, spks, uniforms = _serve_inputs()[:3]
    toks, n = ar_generate(ar, prompts[0], spks[0], sampling=_ar_sampling(), uniforms=uniforms[0])
    grid = perform_simple_inference(nar, _long_nar_batch(), MultinomialDiffusion(K, timesteps=3),
                                    3, _dsh(True), generator=torch.Generator().manual_seed(3))
    steps = n - (len(toks) >= _ar_sampling().max_len)
    for out in outs:
        assert out["tokens"][0][0].tolist() == toks.tolist() and out["tokens"][0][1] == n
        assert torch.equal(out["grid"], grid)
        assert out["k7"] == {(1, 1, 64)} and out["k7_calls"] == 2 * steps
        assert out["k1"] == {(2, 520, 1, 64)} and out["k1_calls"] == 2 * 3
        assert out["k1_strided"]


def _tp_refusal_worker(rank, world):
    import dataclasses as dc

    from mars5_tts_torch.models.ar import CodecLM
    from mars5_tts_torch.models.nar import ResidualTransformer
    from mars5_tts_torch.ops.quant import quantize_codeclm, quantize_nar
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder, ShardedNARDiffusion

    ar, nar = _hd64_models()
    mesh = make_mesh(dp=1, tp=2)
    odd_ar = CodecLM(dc.replace(ar.cfg, n_heads=3, n_kv_heads=3, dim=192))
    odd_nar = ResidualTransformer(dc.replace(nar.cfg, nhead=3, dim=192))
    out = {}
    for name, make in (("quantized AR", lambda: ShardedARDecoder(quantize_codeclm(ar),
                                                                 _ar_sampling(), mesh=mesh)),
                       ("quantized NAR", lambda: ShardedNARDiffusion(quantize_nar(nar), mesh=mesh)),
                       ("3-head AR", lambda: ShardedARDecoder(odd_ar, _ar_sampling(), mesh=mesh)),
                       ("3-head NAR", lambda: ShardedNARDiffusion(odd_nar, mesh=mesh))):
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def test_tp_decoders_refuse_quantized_models_and_heads_tp_does_not_divide():
    """At tp 2 the decoders take float models only (the JAX package shards
    the float tree; the quantized AR engines are not sharded either) and
    refuse head counts tp does not divide (a column shard would split a
    head, and RoPE is per head)."""
    for out in spawn_ranks(_tp_refusal_worker, 2, timeout=120):
        assert "float model" in out["quantized AR"] and "float model" in out["quantized NAR"]
        assert "do not divide by tp=2" in out["3-head AR"]
        assert "do not divide by tp=2" in out["3-head NAR"]


def _one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_module_holds_a_ranks_part(tmp_path, rank):
    """``parallel.tp.shard_module`` at tp 2, rank 0 and 1 (one process):
    the NAR's in-projection keeps the rank's rows of each third (the same
    heads of q, k and v, as DTensor's ``_StridedShard`` places them in
    training), row-parallel weights their columns, the AR's vocabulary its
    rows; replicated parameters share the model's storage; the modules
    that own a collective carry ``tp``, and the model given is left whole."""
    from mars5_tts_torch.parallel import codeclm_specs, nar_specs
    from mars5_tts_torch.parallel.tp import TensorParallel, shard_module

    _, _, ar_sd, _, _, nar_sd = _models()
    _one_rank_group(tmp_path)
    try:
        tp = TensorParallel(dist.group.WORLD, rank, 2)
        nar = _port(nar_sd, "nar", False)
        local = shard_module(nar, nar_specs(nar, 2), tp)
        ar = _port(ar_sd, "ar", False)
        local_ar = shard_module(ar, codeclm_specs(ar, 2), tp)
    finally:
        dist.destroy_process_group()
    w = nar.tfm.decoder.layers[0].self_attn.in_proj_weight
    rows = np.concatenate([np.arange(i * 64 + rank * 32, i * 64 + (rank + 1) * 32)
                           for i in range(3)])
    lay = local.tfm.decoder.layers[0]
    assert torch.equal(lay.self_attn.in_proj_weight, w[rows])
    assert torch.equal(lay.self_attn.out_proj.weight,
                       nar.tfm.decoder.layers[0].self_attn.out_proj.weight[:, rank * 32:][:, :32])
    assert torch.equal(lay.linear2.weight, nar.tfm.decoder.layers[0].linear2.weight[:, rank * 96:][:, :96])
    assert lay.linear2.bias.data_ptr() == nar.tfm.decoder.layers[0].linear2.bias.data_ptr()
    assert lay.tp is tp and lay.self_attn.tp is tp and lay.multihead_attn.tp is tp
    assert local.residual_decoder[0][1].weight.data_ptr() == nar.residual_decoder[0][1].weight.data_ptr()
    assert nar.tfm.decoder.layers[0].tp is None and w.shape == (192, 64)
    assert torch.equal(local_ar.embed.weight, ar.embed.weight[rank * 32:(rank + 1) * 32])
    assert local_ar.tp is tp and local_ar.ar.tp is tp
    assert local_ar.ar.layers[1].attention.tp is tp and local_ar.ar.layers[1].feed_forward.tp is tp
    assert local_ar.spk_encoder.layers[0].tp is None
    assert all(not p.requires_grad for p in local_ar.parameters())


def test_tp_card_check_on_the_cpu():
    """``tools/tp_card.py`` (smoke phase 6 (e)) on the CPU at tiny bf16
    widths (head dim 64, 2 heads): rank 0's one-process references, the two
    ranks' AR run, teacher-forced logits and NAR grid, and ``check``'s
    gates: the ranks equal, the logits and the grid's differing cells
    within ``TF_BUDGET`` of one process's distance from f32, every K7 call
    of the held run within its twin's bound (the CPU's wrappers run their
    twins; the launch gates are the card's)."""
    from mars5_tts_torch.tools import tp_card

    ar = dict(dim=128, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=2, hidden_dim=192,
              n_spk_layers=1, spk_hidden_dim=192)
    nar = dict(dim=128, nhead=2, enc_layers=1, dec_layers=2, n_spk_layers=1, t_emb_dim=64,
               hidden_dim=192)
    spec, outs = tp_card.run(2, ar, nar, device="cpu", timeout=300, new_tokens=30, steps=6)
    rep = tp_card.check(spec, outs, n_layers=2, dec_layers=2, spk_layers=1)
    assert rep["heads_per_rank"] == {"ar": 1, "nar": 1}
    assert rep["tokens"] == rep["ref_tokens"] == 30 and rep["k7_want"] == 2 * 29
    assert rep["k1_want"] == 2 * 6 + 1
    assert 0 < rep["tf_max_abs_diff_tp_vs_one_process"] <= rep["tf_bound"]
    assert rep["grid_cells_differing_share"] <= rep["grid_share_bound"]
    for held in rep["held_against_twins_per_rank"]:
        assert held["decode_attention"]["calls"] == 2 * 29
        assert held["decode_attention"]["max_excess"] <= 0
    assert rep["held_grid_equal_per_rank"] == [True, True]
    assert outs[0]["tf"].shape == (30, 24_000)
