"""A quantized AR pool against its rows' solo runs, on one GPU.

    python3 mars5_tts_torch/tools/pool_rows.py [--rows 4] [--gen 200] [--root DIR]
        [--device cuda]

Builds the released-width AR (26 x 1536, 24,000 ids) with random weights
from a seed and runs six requests (three 30-token prompts and three
560-token ones, each with a 525-frame speaker reference and a stream of
its own; the EOS id lies outside the sampling window, so every row runs to
``max_len`` = 560 + ``--gen``) through a ``ContinuousBatcher`` of
``--rows`` rows on the fused4 engine (chunks of 64 steps, prompt buckets 64
and 576), and each request through ``ar_generate`` on the pool's pack. Three
passes, each timed on the host clock:

* ``cold``: the process's first pool, so the first K2 call builds the
  kernel library when it is not built yet (``build_s`` its nvcc time);
* ``warm``: the same pool again, then the six solo runs;
* ``unpadded``: the pool and the solo runs with the int8 head at the real
  rows (``final_logits`` without its ``HEAD_ROWS`` padding).

Prints one JSON line: each pass's tokens a second, seconds and whether
every pool row equals its solo run. ``--root`` imports ``mars5_tts_torch``
from another checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--gen", type=int, default=200)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from mars5_tts_torch.models import ar_decode_fused as F
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.ops.kernels import build
    from mars5_tts_torch.ops.norms import rms_norm
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pool_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = CodecLMConfig.mars5(24_000)
    if dev.type == "cpu":                    # a dry run: two narrow layers
        cfg = dataclasses.replace(cfg, n_layers=2, dim=256, n_heads=4, n_kv_heads=4,
                                  hidden_dim=512, spk_hidden_dim=256)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(cfg).init_(g).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    n_text, n_speech = 258, 1025                 # the smoke's tokenizers' ids
    eos = n_text + n_speech - 1
    lens = [30, 560, 30, 560, 30, 560]
    prompts = [rng.integers(0, eos, n) for n in lens]
    spk = rng.integers(0, 1024, (525, 8))
    s = ArSampling(n_phones_gen=100, eos_idx=eos, valid_start=n_text, valid_end=eos,
                   max_len=max(lens) + args.gen)
    streams = [rng.random(s.max_len).astype(np.float32) for _ in lens]

    def pool_pass():
        engine = F.FusedEngine(*F.prepare_fused(ar, s.max_len, 4, batch=args.rows))
        pool = ContinuousBatcher(ar, s, engine=engine, batch_size=args.rows, chunk_steps=64,
                                 prompt_buckets=(64, 576), spk_bucket=576)
        reqs = [pool.submit(Request(prompt=p, spk_codes=spk, uniforms=u))
                for p, u in zip(prompts, streams)]
        t0 = time.perf_counter()
        pool.run()
        sync()
        return pool, reqs, time.perf_counter() - t0

    def solo_pass(pool):
        solo = F.FusedEngine(pool.engine.fp, dataclasses.replace(pool.engine.dims, batch=1))
        t0 = time.perf_counter()
        out = [ar_generate(ar, p, spk, sampling=s, uniforms=u, engine=solo)
               for p, u in zip(prompts, streams)]
        sync()
        return out, time.perf_counter() - t0

    def record(pool, reqs, pool_s, solo, solo_s):
        tokens = sum(r.n_gen for r in reqs)
        return {"pool_s": pool_s, "pool_tokens_per_s": tokens / pool_s, "steps": pool.steps_run,
                "tokens": tokens,
                **({} if solo is None else {
                    "solo_s": solo_s, "solo_tokens_per_s": tokens / solo_s,
                    "rows_equal_solo": [bool(np.array_equal(r.tokens, t)) and r.n_gen == n
                                        for r, (t, n) in zip(reqs, solo)]})}

    out = {"rows": args.rows, "root": os.path.abspath(args.root), "prompt_lens": lens,
           "max_len": s.max_len}
    pool, reqs, pool_s = pool_pass()
    out["cold"] = record(pool, reqs, pool_s, None, None)
    out["build_s"] = dict(build.build_seconds)
    pool, reqs, pool_s = pool_pass()
    solo, solo_s = solo_pass(pool)
    out["warm"] = record(pool, reqs, pool_s, solo, solo_s)

    def unpadded(fp, h, cfg):
        hn = rms_norm(h.to(torch.bfloat16), fp["final_norm"], cfg.norm_eps)
        return F.head_logits(fp, hn, cfg.n_vocab)
    F.final_logits = unpadded
    pool, reqs, pool_s = pool_pass()
    solo, solo_s = solo_pass(pool)
    out["unpadded"] = record(pool, reqs, pool_s, solo, solo_s)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
