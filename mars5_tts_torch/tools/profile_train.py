"""Where the time of a training step goes, on one GPU.

    python3 mars5_tts_torch/tools/profile_train.py [--steps 5] [--remat]

Builds the released AR (``CodecLMConfig.mars5(24_000)``) and NAR
(``ResidualTransformerConfig.mars5(4_096)``) in f32 with random weights from
a seed (TF32 off), two ``data.synthetic_corpus`` utterances of 60 text
tokens and 450 frames, ``MultinomialDiffusion(1025, timesteps=200)`` and
AdamW at lr 1e-4, weight decay 0.01, clip 1.0; runs one warm step and
``--steps`` timed ones of ``train.make_train_step`` on the one batch and one
set of NAR draws (``train_run``: AR and NAR ms a step with the device
synchronised, AR tokens a second, peak ``max_memory_allocated`` above what
the process held before, the losses), then one step under
``torch.profiler``: the wall of an unprofiled step beside the device's busy
time (its own events), the idle share, and the device ms of the busiest
ops. Prints one JSON line.

``chip_smoke.py``'s phase 6 runs ``train_run``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

TRAIN_TEXT, TRAIN_FRAMES = 60, 450
TRAIN_TEXT_VOCAB = 256          # text ids below the NAR's 4,096 and the AR's offset


def train_batches(seed: int = 7):
    """Two ``synthetic_corpus`` utterances cut to 60 text tokens and 450
    frames: the AR and NAR batches of ``data.py``."""
    import numpy as np

    from mars5_tts_torch import data

    rng = np.random.default_rng(seed)
    utts = [data.Utterance(rng.integers(0, TRAIN_TEXT_VOCAB, TRAIN_TEXT), u.codes)
            for u in data.synthetic_corpus(2, TRAIN_TEXT_VOCAB, rng=rng,
                                           min_frames=TRAIN_FRAMES,
                                           max_frames=TRAIN_FRAMES + 1)]
    return (data.make_ar_batch(utts, TRAIN_TEXT_VOCAB, eos_idx=24_000 - 1),
            data.make_nar_batch(utts))


def train_models(dev, n_layers: int | None = None, seed: int = 3, remat: bool = False):
    """The released AR and NAR, f32, seeded random weights (``n_layers``:
    that many layers in every stack; ``remat``: per-layer rematerialization)."""
    import dataclasses

    import torch

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig

    ac, nc = CodecLMConfig.mars5(24_000), ResidualTransformerConfig.mars5(4_096)
    if n_layers:
        ac = dataclasses.replace(ac, n_layers=n_layers, n_spk_layers=n_layers)
        nc = dataclasses.replace(nc, enc_layers=n_layers, dec_layers=n_layers,
                                 n_spk_layers=n_layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        return CodecLM(ac, remat=remat).init_(g), ResidualTransformer(nc, remat=remat).init_(g)


def _setup(dev, remat: bool):
    from mars5_tts_torch import train as T
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion

    ar, nar = train_models(dev, remat=remat)
    diff = MultinomialDiffusion(1025, timesteps=200, device=dev)
    opt = T.make_optimizer(1e-4, weight_decay=0.01, clip_norm=1.0)
    state = T.init_train_state(ar, nar, opt, seed=11)
    ab, nb = train_batches()
    draws = T.nar_draws(diff, nb[4].shape, state.generator)
    return state, T.make_train_step(diff, opt, timed=True), ab, nb, draws


def train_run(dev, remat: bool, steps: int) -> dict:
    """One warm step and ``steps`` timed steps on one batch and one set of
    draws; raises unless every loss is finite and (with more than one timed
    step) both losses fell from the first timed step to the last."""
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    state, step, ab, nb, draws = _setup(dev, remat)
    n_params = sum(p.numel() for m in (state.ar, state.nar) for p in m.parameters())
    recs = []
    for _ in range(steps + 1):
        state, m = step(state, ab, nb, draws)
        recs.append({k: float(v) for k, v in m.items()})
    timed = recs[1:]
    ar_ms = [1e3 * r["ar_s"] for r in timed]
    nar_ms = [1e3 * r["nar_s"] for r in timed]
    tokens = ab[0].shape[0] * (ab[0].shape[1] - 1)
    out = {"remat": remat, "params_m": n_params / 1e6, "ar_ms": ar_ms, "nar_ms": nar_ms,
           "ar_ms_median": statistics.median(ar_ms), "nar_ms_median": statistics.median(nar_ms),
           "ar_tokens_per_s": tokens / (statistics.median(ar_ms) / 1e3),
           "peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
           "base_gb": base / 1e9,
           "ar_loss": [r["ar_loss"] for r in timed], "nar_loss": [r["nar_loss"] for r in timed],
           "warm_ms": 1e3 * (recs[0]["ar_s"] + recs[0]["nar_s"])}
    del state
    losses = out["ar_loss"] + out["nar_loss"]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"training (remat={remat}): a loss is not finite: {losses}")
    if steps > 1 and not (out["ar_loss"][-1] < out["ar_loss"][0]
                          and out["nar_loss"][-1] < out["nar_loss"][0]):
        raise RuntimeError(f"training (remat={remat}): a loss did not fall over the steps: "
                           f"{out['ar_loss']} / {out['nar_loss']}")
    return out


def profile_step(dev, remat: bool = False) -> dict:
    """Wall ms of an unprofiled step, then one step under the profiler:
    device busy ms, idle share, the busiest ops' device ms and counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.tools.profile_ar import device_us

    state, step, ab, nb, draws = _setup(dev, remat)
    for _ in range(2):
        state, _ = step(state, ab, nb, draws)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, m = step(state, ab, nb, draws)
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, ab, nb, draws)
        torch.cuda.synchronize(dev)
    events = prof.key_averages()
    busy = device_us(events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:15]
    return {"wall_ms": wall, "ar_ms": 1e3 * m["ar_s"], "nar_ms": 1e3 * m["nar_s"],
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "top_device_ms": [(e.key[:60], e.device_time_total / 1e3, e.count) for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "run": train_run(dev, args.remat, args.steps),
           "profile": profile_step(dev, args.remat)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
