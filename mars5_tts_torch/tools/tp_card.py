"""Tensor-parallel decoding by ranks that share one card
(``chip_smoke.py`` phase 6 (e), ``tests/test_torch_cuda.py``).

NCCL refuses two ranks on one device, so the ranks of one gloo group share
the card (gloo's all-reduce takes CUDA tensors). Each rank builds the bf16
AR (``CodecLMConfig.mars5(24_000)``) and NAR
(``ResidualTransformerConfig.mars5(4_096)``) from the seed
``chip_smoke.py`` builds them from (the layer counts may be cut), then:

1. rank 0 runs the references on the whole models, alone: the AR request
   (``ar_generate``), its teacher-forced logits (``teacher_forced_logits``:
   the same prompt, then the generated tokens fed one a step) in bf16 and
   again with the weights in f32, the request again in f32, and the NAR
   grid (``perform_simple_inference``) in bf16 and in f32;
2. every rank takes its shards (``serving.multichip.ShardedARDecoder`` /
   ``ShardedNARDiffusion`` at dp 1 x tp), then runs the same AR request
   (K7's launches counted around it) and the NAR grid on the same draws
   (K1's launches counted), both timed;
3. every rank runs the teacher-forced logits of rank 0's tokens and the
   NAR grid again with each K7 and K1 call held against its twin on the
   same inputs (``held_against_twins``): the kernels at the shapes and
   strides this path gives them, on the rank's heads.

``check`` holds the results to the gates: every rank the same tokens, grid
and logits; the teacher-forced logits within ``TF_BUDGET`` times the bf16
model's own distance from f32, and the share of grid cells that differ
from one process's within ``TF_BUDGET`` times the share by which one
process's bf16 grid differs from its f32 grid (see ``check``); every K7
and K1 call of step 3 within its twin's bound; K7 once a layer a decode
step and K1 once a decoder layer a reverse step plus the speaker encoder's
layers. It reports, without gating, how far the tokens agree with the one
process run (beside how far one process's bf16 and f32 runs agree) and
whether the held grid equals the timed one. Times are of ranks sharing one
card over gloo, not tensor-parallel throughput.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time

# TP rounds each row-parallel sum up to three times (each rank's partial in
# bf16, then the f32 sum back to bf16) where one process rounds it once
TF_BUDGET = 3.0


def build_bf16(dev, ar: dict | None = None, nar: dict | None = None):
    """The released-width AR and NAR in bf16, drawn as ``chip_smoke.py``
    draws them (one generator seeded 0 on ``dev``, the AR first); ``ar`` /
    ``nar``: config fields to change (layer counts, or a tiny geometry for
    the CPU tests)."""
    import torch

    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig

    ar_cfg = dataclasses.replace(CodecLMConfig.mars5(24_000), **(ar or {}))
    nar_cfg = dataclasses.replace(ResidualTransformerConfig.mars5(4_096), **(nar or {}))
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        ar = CodecLM(ar_cfg).init_(g).to(torch.bfloat16)
        nar = ResidualTransformer(nar_cfg).init_(g).to(torch.bfloat16)
    return ar.requires_grad_(False).eval(), nar.requires_grad_(False).eval()


def teacher_forced_logits(model, prompt, spk_codes, forced, window: int):
    """(len(forced), V) f32 logits of one row: the prefill's at the prompt's
    last token, then a decode step a token of ``forced`` (each at its own
    position, as the decode loop feeds it), whatever the model would have
    sampled. ``model`` may be a tensor-parallel copy."""
    import torch

    from mars5_tts_torch.models.ar_decode import RingCache, decode_step, prefill_rows

    with torch.no_grad():
        logits, kvs = prefill_rows(model, [prompt], [spk_codes], window)
        k0 = kvs[0][0][0]
        cache = RingCache(model.cfg.n_layers, 1, window, k0.shape[2], model.cfg.head_dim,
                          k0.dtype, logits.device)
        cache.write_prompt(0, kvs[0])
        out = [logits]
        for j, t in enumerate(forced[:-1]):
            out.append(decode_step(model, [int(t)], [len(prompt) + 1 + j], cache))
    return torch.cat(out)


def request(new_tokens: int = 100, steps: int = 20) -> dict:
    """The run's inputs: an AR request of 120 ids, a 150-frame speaker
    reference and its uniforms, capped at ``new_tokens`` generated tokens
    (EOS pushed past the cap); a deep-clone NAR row of 60 text ids, 525
    prompt frames and 200 generated ones (its decoder self-attention and
    speaker encoder, from 512 frames up, run kernel K1), ``steps`` reverse
    steps at CFG w = 3 on a seeded generator."""
    import numpy as np

    seed, prompt_len, text_len, prompt_frames, frames = 71, 120, 60, 525, 200
    rng = np.random.default_rng(seed)
    max_len = prompt_len + new_tokens
    return {
        "prompt": rng.integers(0, 258 + 1025, prompt_len), "spk": rng.integers(0, 1024, (150, 8)),
        "uniforms": rng.random(max_len).astype(np.float32),
        "sampling": dict(temperature=0.7, top_k=200, top_p=0.9, n_phones_gen=max_len,
                         eos_idx=258 + 1024, valid_start=258, valid_end=258 + 1025,
                         max_len=max_len),
        "nar_batch": (rng.integers(0, 4096, (1, text_len)),
                      rng.integers(0, 1024, (1, prompt_frames, 8)), np.array([text_len]),
                      np.array([prompt_frames]), rng.integers(0, 1024, (1, frames, 8)),
                      np.zeros((1, frames), bool)),
        "steps": steps, "nar_seed": seed,
        "dsh": dict(last_greedy=True, x_0_temp=0.7, guidance_w=3.0, deep_clone=True)}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@contextlib.contextmanager
def held_against_twins(held: dict):
    """While it lasts, every call of K7 by the AR's decode step and of K1
    (``ops.kernels.mha.mha``) runs the kernel's wrapper, then its twin on the
    same inputs, and returns the wrapper's output. ``held`` gathers, by
    kernel: the calls, the distinct (query, key or ring) shapes and
    whether the inputs were strided views, the largest |kernel - twin| and
    the largest excess over the stated bound (K7 one ulp, ``one_ulp``; K1
    2 bf16 ulp of each row's peak, ``bf16_row_bound``), kept on the device
    until the block ends. The twins' work does not count as launches."""
    import torch

    from mars5_tts_torch.models import ar_decode
    from mars5_tts_torch.ops.kernels import decode_attention as A, mha as K

    k7, k1 = ar_decode.decode_attention, K.mha

    def note(name, got, want, tol, q, k):
        rec = held.setdefault(name, {"calls": 0, "shapes": set(), "err": [], "excess": []})
        diff = (got.float() - want.float()).abs()
        rec["calls"] += 1
        rec["shapes"].add((tuple(q.shape), tuple(k.shape), not (q.is_contiguous()
                                                                and k.is_contiguous())))
        rec["err"].append(diff.max())
        rec["excess"].append((diff - tol).max())

    def k7_held(q, ck, cv, pos, k_new=None, v_new=None, max_pos=None):
        got = k7(q, ck, cv, pos, k_new, v_new, max_pos=max_pos)
        want = A.decode_attention_ref(q, ck, cv, pos, k_new, v_new)
        note("decode_attention", got, want, A.one_ulp(got, want), q, ck)
        return got

    def k1_held(q, k, v, key_padding_mask=None, quantized=False):
        if quantized:
            raise RuntimeError("the tensor-parallel NAR runs no int8 attention")
        got = k1(q, k, v, key_padding_mask)
        want = K.mha_ref(q, k, v, key_padding_mask)
        note("mha", got, want, K.bf16_row_bound(want), q, k)
        return got

    ar_decode.decode_attention, K.mha = k7_held, k1_held
    try:
        yield held
    finally:
        ar_decode.decode_attention, K.mha = k7, k1
        for rec in held.values():
            rec["shapes"] = sorted(rec["shapes"])
            rec["max_abs_err"] = torch.stack(rec.pop("err")).max().item()
            rec["max_excess"] = torch.stack(rec.pop("excess")).max().item()


def tp_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank (``run``): the references (rank 0), then its shards' AR
    run, teacher-forced logits and NAR grid; on the card unless
    ``spec["device"]`` says otherwise."""
    import torch
    import torch.distributed as dist

    from mars5_tts_torch.config import DSH
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.ar_decode import ArSampling, ar_generate
    from mars5_tts_torch.ops.kernels import decode_attention as A, mha as K
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder, ShardedNARDiffusion

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ar, nar = build_bf16(dev, spec["ar"], spec["nar"])
    s = ArSampling(**spec["sampling"])
    window = min(ar.cfg.sliding_window, s.max_len + 1)
    diff = MultinomialDiffusion(1025, timesteps=spec["steps"], device=dev)
    dsh = DSH(**spec["dsh"])
    prompt, spk, u, batch = spec["prompt"], spec["spk"], spec["uniforms"], spec["nar_batch"]
    n_p = len(prompt)

    def nar_run(model):
        gen = torch.Generator(device=dev).manual_seed(spec["nar_seed"])
        return perform_simple_inference(model, batch, diff, diff.num_timesteps, dsh,
                                        generator=gen)

    ref = None
    if rank == 0:
        t0 = _sync(dev)
        tokens, n_gen = ar_generate(ar, prompt, spk, sampling=s, uniforms=u)
        t1 = _sync(dev)
        grid = nar_run(nar)
        t2 = _sync(dev)
        forced = tokens[n_p:]
        ar32, nar32 = copy.deepcopy(ar).float(), copy.deepcopy(nar).float()
        ref = {"tokens": tokens, "n_gen": n_gen, "grid": grid.cpu(),
               "ar_ms_per_token": 1e3 * (t1 - t0) / max(n_gen, 1),
               "nar_ms_per_step": 1e3 * (t2 - t1) / diff.num_timesteps,
               "tf": teacher_forced_logits(ar, prompt, spk, forced, window).cpu(),
               "tf_f32": teacher_forced_logits(ar32, prompt, spk, forced, window).cpu(),
               "tokens_f32": ar_generate(ar32, prompt, spk, sampling=s, uniforms=u)[0],
               "grid_f32": nar_run(nar32).cpu()}
        del ar32, nar32
    box = [None if ref is None else ref["tokens"][n_p:]]
    dist.broadcast_object_list(box, src=0)
    forced = box[0]

    mesh = make_mesh(dp=1, tp=world)
    dec = ShardedARDecoder(ar, s, mesh=mesh)
    svc = ShardedNARDiffusion(nar, mesh=mesh)
    del ar, nar
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"rank": rank, "ref": ref,
           "param_bytes": sum(p.numel() * p.element_size() for m in (dec.model, svc.model)
                              for p in m.parameters())}

    dist.barrier()
    A.reset_launch_count()
    t0 = _sync(dev)
    ((tokens, n_gen),) = dec.generate([prompt], [spk], uniforms=[u])
    t1 = _sync(dev)
    out.update(tokens=tokens, n_gen=n_gen, k7=A.launch_count,
               ar_ms_per_token=1e3 * (t1 - t0) / max(n_gen, 1))

    def sharded_nar_run():
        gen = torch.Generator(device=dev).manual_seed(spec["nar_seed"])
        return svc.infer(batch, diff, diff.num_timesteps, dsh, generator=gen).cpu()

    dist.barrier()
    K.reset_launch_count()
    t0 = _sync(dev)
    grid = sharded_nar_run()
    t1 = _sync(dev)
    out.update(grid=grid, k1=K.launch_count,
               nar_ms_per_step=1e3 * (t1 - t0) / diff.num_timesteps,
               heads={"ar": dec.model.ar.layers[0].attention.wq.weight.shape[0]
                      // dec.model.cfg.head_dim,
                      "nar": svc.model.tfm.decoder.layers[0].self_attn.in_proj_bias.shape[0]
                      // 3 // (svc.model.cfg.dim // svc.model.cfg.nhead)})

    dist.barrier()
    with held_against_twins({}) as held:
        out["tf"] = teacher_forced_logits(dec.model, prompt, spk, forced, window).cpu()
        out["held_grid_equal"] = bool(torch.equal(sharded_nar_run(), grid))
    out.update(held=held,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    return out


def run(tp: int = 2, ar: dict | None = None, nar: dict | None = None, device: str = "cuda:0",
        timeout: float = 600.0, **request_kw) -> tuple[dict, list]:
    """``tp`` ranks of one gloo group on ``device``, each ``tp_rank`` over
    ``build_bf16(ar, nar)``; returns (the spec, the ranks' results)."""
    from mars5_tts_torch.parallel.launch import spawn_ranks

    spec = {**request(**request_kw), "ar": ar, "nar": nar, "device": device}
    return spec, spawn_ranks(tp_rank, tp, spec, timeout=timeout)


def check(spec: dict, outs: list, n_layers: int, dec_layers: int, spk_layers: int) -> dict:
    """The gates over ``run``'s results (raises RuntimeError naming the
    first that fails) and the report.

    * every rank the same tokens, grid and teacher-forced logits;
    * the teacher-forced logits: max |tp - one process| <= ``TF_BUDGET`` x
      max |one process - f32|. One process's bf16 logits stand from the
      same weights in f32 by the bf16 roundings of every layer; TP changes
      only the roundings of its row-parallel sums (two a layer), each of
      which it may round three times where one process rounds once;
    * the grid: the share of its cells that differ from one process's <=
      ``TF_BUDGET`` x the share by which one process's bf16 grid differs
      from its f32 grid. A cell flips where its logits' roundings move a
      draw across a near-tie, and the flip feeds the later steps; TP's
      roundings change no more than that budget of bf16's own;
    * every K7 and K1 call of the held runs within its twin's bound, on
      every rank; on the card, both kernels held at least once;
    * on the card, K7 ``n_layers`` launches a decode step on each rank; K1
      ``dec_layers`` a reverse step plus ``spk_layers`` once (the speaker
      encoder) on each rank (the CPU's wrappers run their twins and count
      nothing)."""
    import numpy as np

    from mars5_tts_torch.diffusion.schedule import build_step_plan

    first, ref = outs[0], outs[0]["ref"]
    for o in outs[1:]:
        if o["n_gen"] != first["n_gen"] or o["tokens"].tolist() != first["tokens"].tolist():
            raise RuntimeError(f"tp rank {o['rank']} drew other tokens than rank 0")
        if not (o["grid"] == first["grid"]).all():
            raise RuntimeError(f"tp rank {o['rank']} made another grid than rank 0")
        if not (o["tf"] == first["tf"]).all():
            raise RuntimeError(f"tp rank {o['rank']} holds other logits than rank 0")
    own = (ref["tf"] - ref["tf_f32"]).abs().max().item()
    got = (first["tf"] - ref["tf"]).abs().max().item()
    n_p = len(spec["prompt"])
    max_len = spec["sampling"]["max_len"]
    steps = first["n_gen"] - (len(first["tokens"]) >= max_len)
    _, is_reverse, _ = build_step_plan(spec["steps"])
    lc = spec["nar_batch"][1].shape[1]
    k1_want = dec_layers * int(np.sum(is_reverse)) + (spk_layers if lc + 1 >= 512 else 0)
    grid_share = float((first["grid"] != ref["grid"]).float().mean())
    grid_own = float((ref["grid"] != ref["grid_f32"]).float().mean())

    def agree(a, b):
        a, b = a[n_p:], b[n_p:]
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))

    rep = {"tp": len(outs), "heads_per_rank": first["heads"],
           "tokens": int(first["n_gen"]), "ref_tokens": int(ref["n_gen"]),
           "tokens_agreeing_before_first_difference": agree(ref["tokens"], first["tokens"]),
           "one_process_bf16_vs_f32_tokens_agreeing": agree(ref["tokens"], ref["tokens_f32"]),
           "grid_cells_differing_share": grid_share,
           "one_process_bf16_vs_f32_grid_cells_differing_share": grid_own,
           "grid_share_bound": TF_BUDGET * grid_own,
           "held_against_twins_per_rank": [o["held"] for o in outs],
           "held_grid_equal_per_rank": [o["held_grid_equal"] for o in outs],
           "tf_max_abs_diff_tp_vs_one_process": got, "tf_max_abs_diff_one_process_vs_f32": own,
           "tf_bound": TF_BUDGET * own, "tf_ratio": got / own if own else None,
           "k7_per_rank": [o["k7"] for o in outs], "k7_want": n_layers * steps,
           "k1_per_rank": [o["k1"] for o in outs], "k1_want": k1_want,
           "ar_ms_per_token_per_rank": [o["ar_ms_per_token"] for o in outs],
           "nar_ms_per_step_per_rank": [o["nar_ms_per_step"] for o in outs],
           "one_process_ar_ms_per_token": ref["ar_ms_per_token"],
           "one_process_nar_ms_per_step": ref["nar_ms_per_step"],
           "param_bytes_per_rank": [o["param_bytes"] for o in outs],
           "peak_bytes_per_rank": [o["peak_bytes"] for o in outs]}
    if not np.isfinite(got) or got > TF_BUDGET * own:
        raise RuntimeError(f"teacher-forced logits at tp={len(outs)} stand {got:.4g} from one "
                           f"process's, past {TF_BUDGET} x {own:.4g}")
    if grid_share > TF_BUDGET * grid_own:
        raise RuntimeError(f"{grid_share:.4%} of the grid's cells at tp={len(outs)} differ from "
                           f"one process's, past {TF_BUDGET} x {grid_own:.4%}")
    for o in outs:
        for name, h in o["held"].items():
            if not h["max_excess"] <= 0:
                raise RuntimeError(f"tp rank {o['rank']}: {name} stands {h['max_abs_err']:.3e} "
                                   f"from its twin, past its bound, at {h['shapes']}")
    if not spec["device"].startswith("cuda"):
        return rep
    if any(set(o["held"]) != {"decode_attention", "mha"} for o in outs):
        raise RuntimeError(f"K7 and K1 were not both held against their twins: "
                           f"{[sorted(o['held']) for o in outs]}")
    if any(o["k7"] != n_layers * steps for o in outs):
        raise RuntimeError(f"K7 launched {rep['k7_per_rank']} times per rank, expected "
                           f"{n_layers} x {steps} decode steps")
    if any(o["k1"] != k1_want for o in outs):
        raise RuntimeError(f"K1 launched {rep['k1_per_rank']} times per rank, expected {k1_want}")
    return rep
