"""Entry points of the port: a forward step of the MARS5-width AR,
and a multi-process sharding dry run (counterpart of the repo root's
``__graft_entry__.py``, which drives the JAX package).

    python -m mars5_tts_torch.graft_entry [N]      # dryrun_multichip(N), default 4
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# the JAX dry run's tiny geometry, every width divisible by tp = 4
TINY_AR = dict(n_vocab=64, dim=64, n_heads=4, n_kv_heads=4, head_dim=16, n_layers=2,
               hidden_dim=96, sliding_window=32, n_spk_layers=2, spk_hidden_dim=192)


def entry(device=None):
    """``(fn, example_args)``: a forward step of the flagship AR.

    ``CodecLMConfig.mars5(n_vocab=24_000)`` (26 layers, dim 1536, 24 heads,
    window 3000) in bf16 with seeded random weights; ``fn(model, tokens, spk_codes)`` embeds (1, 64) tokens, runs
    the speaker encoder over (1, 75, 8) reference codes and returns the
    (1, 64, 24_000) vocabulary logits. On the card unless ``device`` says
    otherwise (``pipeline.resolve_device``)."""
    from .models.ar import CodecLM, CodecLMConfig
    from .pipeline import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = CodecLM(CodecLMConfig.mars5(n_vocab=24_000)).init_(torch.Generator(device=dev).manual_seed(0))
    model = model.to(torch.bfloat16).requires_grad_(False).eval()

    @torch.no_grad()
    def fn(model, tokens, spk_codes):
        return model(tokens, spk_codes=spk_codes)

    tokens = torch.zeros((1, 64), dtype=torch.long, device=dev)
    spk_codes = torch.zeros((1, 75, 8), dtype=torch.long, device=dev)
    return fn, (model, tokens, spk_codes)


def mesh_shape(n: int) -> tuple[int, int]:
    """(dp, tp) of ``n`` ranks, the JAX dry run's rule: tp = 4 when 4
    divides n, else 2 when 2 does, else 1."""
    tp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return n // tp, tp


def _tiny_models():
    """The dry run's seeded f32 AR and NAR (the same on every rank)."""
    from .models.ar import CodecLM, CodecLMConfig
    from .models.nar import ResidualTransformer, ResidualTransformerConfig

    ar = CodecLM(CodecLMConfig(**TINY_AR)).init_(torch.Generator().manual_seed(0))
    nar = ResidualTransformer(ResidualTransformerConfig.tiny(n_text_vocab=32)).init_(
        torch.Generator().manual_seed(1))
    return ar, nar


def _dryrun_rank(rank: int, world: int) -> dict:
    """One rank of ``dryrun_multichip``: every check raises where it fails."""
    from .config import DSH
    from .diffusion.engine import perform_simple_inference
    from .diffusion.multinomial import MultinomialDiffusion
    from .models.ar_decode import ArSampling, ar_generate_batched
    from .parallel import codeclm_specs, make_mesh, nar_specs
    from .serving.multichip import ShardedARDecoder, ShardedNARDiffusion
    from .train import init_train_state, make_optimizer, make_train_step, shard_train_state

    dp, tp = mesh_shape(world)
    mesh = make_mesh(dp=dp, tp=tp)
    diff = MultinomialDiffusion(1025, timesteps=8)
    rng = np.random.default_rng(0)

    # 1. one dp x tp train step
    optimizer = make_optimizer(1e-4)
    ar, nar = _tiny_models()
    state = shard_train_state(mesh, init_train_state(ar, nar, optimizer),
                              codeclm_specs(ar, tp), nar_specs(nar, tp))
    bs = 2 * dp
    ar_batch = (rng.integers(0, 64, (bs, 16)), np.ones((bs, 15), np.float32),
                rng.integers(0, 1024, (bs, 6, 8)))
    nar_batch = (rng.integers(0, 32, (bs, 5)), rng.integers(0, 1024, (bs, 6, 8)),
                 np.full(bs, 5), np.full(bs, 6), rng.integers(0, 1024, (bs, 7, 8)),
                 np.zeros((bs, 7), bool))
    _, metrics = make_train_step(diff, optimizer)(state, ar_batch, nar_batch)
    losses = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite losses {losses}")

    # 2. data-parallel AR decode and NAR grid, bitwise one process's
    ar, nar = (m.requires_grad_(False) for m in _tiny_models())
    s = ArSampling(temperature=0.7, top_k=10, top_p=0.9, n_phones_gen=6, eos_idx=60,
                   valid_start=20, valid_end=64, max_len=24)
    prompts = [rng.integers(0, 20, 5), rng.integers(0, 20, 8)]
    spks = [rng.integers(0, 1024, (4, 8)) for _ in prompts]
    us = [rng.random(s.max_len).astype(np.float32) for _ in prompts]
    want = ar_generate_batched(ar, prompts, spks, sampling=s, uniforms=np.stack(us, 1))
    dp_mesh = make_mesh(dp=world, tp=1)
    got = ShardedARDecoder(ar, s, mesh=dp_mesh).generate(prompts, spks, uniforms=us)
    _same_tokens(got, want, "the data-parallel AR decode")

    T, lx, nb = diff.num_timesteps, 7, world
    batch = (rng.integers(0, 32, (nb, 5)), rng.integers(0, 1025, (nb, 6, 8)), np.full(nb, 5),
             np.full(nb, 6), rng.integers(0, 1025, (nb, lx, 8)), np.zeros((nb, lx), bool))
    dsh = DSH(deep_clone=False, x_0_temp=0.7, guidance_w=1.5)
    nar_u = rng.random((T, 2, nb, lx, 8, 1025)).astype(np.float32)
    x_init = rng.integers(0, 1025, (nb, lx, 8))
    grid = perform_simple_inference(nar, batch, diff, T, dsh, uniforms=nar_u, x_init=x_init)
    got = ShardedNARDiffusion(nar, mesh=dp_mesh).infer(batch, diff, T, dsh, uniforms=nar_u,
                                                       x_init=x_init)
    if not torch.equal(got, grid):
        raise RuntimeError("the data-parallel NAR grid parted from one process's")

    # 3. tensor-parallel AR decode (and NAR grid) on the dp x tp mesh
    got = ShardedARDecoder(ar, s, mesh=mesh).generate(prompts, spks, uniforms=us)
    _same_tokens(got, want, f"the tp={tp} AR decode")
    got = ShardedNARDiffusion(nar, mesh=mesh).infer(batch, diff, T, dsh, uniforms=nar_u,
                                                    x_init=x_init)
    if not torch.equal(got, grid):
        raise RuntimeError(f"the tp={tp} NAR grid parted from one process's")
    return {"dp": dp, "tp": tp, **losses}


def _same_tokens(got, want, what: str) -> None:
    for (toks, n), (wt, wn) in zip(got, want, strict=True):
        if n != wn or toks.tolist() != wt.tolist():
            raise RuntimeError(f"{what} parted from one process's")


def rank_parameter_bytes(tp: int) -> int:
    """Bytes of rank 0's part of the MARS5-geometry bf16 AR under
    ``codeclm_specs`` at ``tp``: the model is built on the ``meta`` device,
    so nothing is allocated. Parameters only (the JAX dry run reads a
    compiler's whole memory estimate, which PyTorch has no counterpart of)."""
    from .models.ar import CodecLM, CodecLMConfig
    from .parallel import codeclm_specs
    from .parallel.tp import local_shard

    with torch.device("meta"):
        ar = CodecLM(CodecLMConfig.mars5(n_vocab=24_000)).to(torch.bfloat16)
    specs = codeclm_specs(ar, tp)
    return sum(local_shard(p, specs[n], 0, tp).numel() * p.element_size()
               for n, p in ar.named_parameters())


def dryrun_multichip(n_devices: int) -> None:
    """One dp x tp training step and the sharded decoders over ``n_devices``
    gloo processes on the host (the JAX dry run's virtual CPU devices).

    The mesh is ``mesh_shape(n_devices)``; the AR shards Megatron-style
    (heads, FFN, vocabulary) and the NAR its attention (head-aligned) and
    SwiGLU FFNs (``parallel/sharding.py``); batches shard on dp. In order:
    one train step with finite losses; the data-parallel AR decode and NAR
    grid, each bitwise one process's; the tensor-parallel AR decode and NAR
    grid on the dp x tp mesh, equal to one process's (f32 at tiny widths);
    the per-rank parameter bytes of the MARS5-geometry AR at that tp.
    Prints one ``dryrun_multichip OK: ...`` line; raises on any failure."""
    from .parallel.launch import spawn_ranks

    outs = spawn_ranks(_dryrun_rank, n_devices, timeout=900)
    dp, tp = outs[0]["dp"], outs[0]["tp"]
    full, mine = rank_parameter_bytes(1), rank_parameter_bytes(tp)
    print(f"dryrun_multichip OK: mesh dp={dp} tp={tp}, ar_loss={outs[0]['ar_loss']:.4f} "
          f"nar_loss={outs[0]['nar_loss']:.4f}, sharded AR decode bit-identical, sharded NAR "
          f"diffusion grid bit-identical, tp={tp} AR decode and NAR grid equal to one "
          f"process's, mars5-geom AR parameters per rank {mine / 2 ** 30:.2f} GiB bf16 "
          f"(of {full / 2 ** 30:.2f} GiB whole)", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
