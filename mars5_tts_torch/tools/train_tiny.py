"""Training on tiny models over a dp x tp mesh of processes.

    python3 mars5_tts_torch/tools/train_tiny.py [--device cpu] [--world 4] [--steps 20]
        [--out DIR]

Spawns ``--world`` processes in one ``torch.distributed`` group: on the
CPU gloo ranks (default 4), on the card one NCCL rank a card (default every
card PyTorch sees); tp is 2 when it divides the ranks, so 4 ranks are dp 2
x tp 2 and one card dp 1 x tp 1. Each builds the
same seeded tiny AR and NAR, places them on the mesh
(``train.shard_train_state``: Megatron-style over tp, replicated over dp),
and trains ``--steps`` combined steps (``train.make_train_step``, AdamW at
3e-4) on ``data.synthetic_corpus`` batches sharded over dp. Rank 0 prints
the losses, fails unless the AR loss fell, and saves both models in the
reference's checkpoint layout (``hub.save_checkpoint``, ``.pt``, wq / wk
rows back in the reference's RoPE order) under ``--out`` (default
``build/train_tiny`` in the checkout).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N_TEXT = 64                          # toy joint vocabulary: 64 text ids, 1024 codes, EOS
EOS = N_TEXT + 1024
AR_TINY = dict(n_vocab=N_TEXT + 1024 + 2, dim=64, n_heads=4, n_kv_heads=4, head_dim=16,
               n_layers=2, hidden_dim=96, sliding_window=128, n_spk_layers=2,
               spk_hidden_dim=192)


def train_rank(rank: int, world: int, device: str, dp: int, tp: int, steps: int, out: str):
    """One rank's run; rank 0 returns the losses by step and the saved
    paths, the others None."""
    import dataclasses

    import torch

    from mars5_tts_torch.data import batches, synthetic_corpus
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.hub import save_checkpoint
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.convert import unpermute_rope_rows
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.parallel import codeclm_specs, make_mesh, nar_specs
    from mars5_tts_torch.train import (_full, init_train_state, make_optimizer, make_train_step,
                                       shard_train_state)

    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(dp=dp, tp=tp)
    with torch.device(dev):
        ar_cfg = CodecLMConfig(**AR_TINY)
        nar_cfg = ResidualTransformerConfig.tiny(n_text_vocab=N_TEXT)
        ar = CodecLM(ar_cfg).init_(torch.Generator(device=dev).manual_seed(0))
        nar = ResidualTransformer(nar_cfg).init_(torch.Generator(device=dev).manual_seed(1))
    diff = MultinomialDiffusion(nar_cfg.n_quant, timesteps=32, device=dev)
    optimizer = make_optimizer(3e-4)
    state = shard_train_state(mesh, init_train_state(ar, nar, optimizer, seed=2),
                              codeclm_specs(ar, tp), nar_specs(nar, tp))
    corpus = synthetic_corpus(64 * dp, text_vocab=N_TEXT)
    train_step = make_train_step(diff, optimizer)
    losses, it = [], iter(())
    t0 = time.perf_counter()
    for step in range(steps):
        try:
            ar_b, nar_b = next(it)
        except StopIteration:
            it = batches(corpus, batch_size=2 * dp, seed=step, n_text_vocab_offset=N_TEXT,
                         eos_idx=EOS, ar_pad_to=96, spk_pad_to=64, frames_pad_to=64,
                         text_pad_to=24)
            ar_b, nar_b = next(it)
        _, m = train_step(state, ar_b, nar_b)
        losses.append((float(m["ar_loss"]), float(m["nar_loss"])))
    seconds = time.perf_counter() - t0
    trees = {name: {k: _full(v.detach()).float().cpu().numpy()
                    for k, v in model.state_dict().items()}
             for name, model in (("ar", state.ar), ("nar", state.nar))}
    if rank:
        return None
    for k in [k for k in trees["ar"] if k.endswith(("attention.wq.weight", "attention.wk.weight"))]:
        trees["ar"][k] = unpermute_rope_rows(trees["ar"][k], ar_cfg.head_dim)
    Path(out).mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, cfg in (("ar", ar_cfg), ("nar", nar_cfg)):
        paths[name] = str(Path(out) / f"mars5_{name}_tiny.pt")
        save_checkpoint(paths[name], trees[name],
                        config=cfg.to_dict() if name == "ar" else dataclasses.asdict(cfg))
    return {"losses": losses, "seconds": seconds, "paths": paths}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 4 on the CPU, one a card on the card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "train_tiny"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from mars5_tts_torch.parallel.launch import spawn_ranks
    from mars5_tts_torch.pipeline import resolve_device

    dev = resolve_device(args.device).type
    world = args.world or (torch.cuda.device_count() if dev == "cuda" else 4)
    tp = 2 if world % 2 == 0 else 1
    print(f"ranks={world} ({'nccl' if dev == 'cuda' else 'gloo'}, {dev}) mesh dp={world // tp} "
          f"tp={tp}", flush=True)
    res = spawn_ranks(train_rank, world, dev, world // tp, tp, args.steps, args.out,
                      backend="nccl" if dev == "cuda" else "gloo", timeout=1800)[0]
    losses = res["losses"]
    for step in range(0, len(losses), max(len(losses) // 5, 1)):
        print(f"step {step}: ar={losses[step][0]:.4f} nar={losses[step][1]:.4f}")
    (a0, n0), (a1, n1) = losses[0], losses[-1]
    print(f"{len(losses)} steps in {res['seconds']:.1f} s | ar loss {a0:.4f} -> {a1:.4f} | "
          f"nar loss {n0:.4f} -> {n1:.4f}")
    if not a1 < a0:
        raise SystemExit("train_tiny: the AR loss did not fall")
    print("saved " + ", ".join(res["paths"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
