"""The comparison that decides ``correct``: what the window's requests produced
against the plain reference (``portbench/reference``), after the window.

The reference of each route is found by the configuration's options:
``reference/ar_<ar_backend>.py`` for the AR, ``reference/nar_<nar_backend>.py``
for the NAR. Every setting a request states (the sampling, the CFG weight,
the temperature, T, the guidance interval) comes from the configuration and
the traffic, never from the program.

The calls compared are chosen before the window (``chosen``): its longest
and others drawn from the seed. Numbers:

* ``ar_miss``: the served tokens of a sample of their rows, teacher-forced
  through the reference and drawn by the reference sampler
  (``reference/sampling.py``) on the uniforms the program's AR drew them
  with; the share of served tokens the reference does not draw with its
  nucleus, nor with the nucleus one token narrower or wider (whether the
  nucleus's last token is in turns on rounding: top-p cuts a flat tail).
  Inf where a prompt is not the one the request states.
* ``nar_gap``: every reverse step of every call of the window runs the rows
  the guidance interval asks for (the unconditional rows on the CFG steps,
  none on the others; inf otherwise); three kept reverse steps of each
  compared call (one without CFG, one with it, t = 0) are rerun on the
  program's own x_t and uniforms, and the number is the widest gap by which
  the code the program drew scores below the reference's best (the scores
  are the posterior's log probabilities plus the Gumbel noise of those
  uniforms, so a program that agrees with the reference draws the
  reference's argmax).
* ``codes_diff``: the share of the reference audio's Encodec codes that
  differ from the reference's.
* ``audio_err``: Vocos's audio of the program's code grid against the
  reference's of the same grid, the largest difference over the
  reference's peak.

``control=True`` puts the reference in the program's place at the
precision below the configuration's (each route's module says which; Encodec
and Vocos with TF32), and reads the same numbers of it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from . import weights
from .reference import codec as ref_codec
from .reference import sampling
from .reference.diffusion import Tables, guided

TEXT_VOCAB, SPEECH_VOCAB = 258, 1025         # the stand-in tokenizers' ids
SOT, EOT = 256, 257
EOS = TEXT_VOCAB + SPEECH_VOCAB - 1          # <|endofspeech|>
SAMPLE = 3                                   # calls compared
AR_ROWS = 8                                  # rows of those calls teacher-forced


def chosen(cycle, n: int, seed: int) -> set:
    """The indices of the window's calls the comparison reads, among its
    first ``n`` (which every run completes): the one of the longest output
    and ``SAMPLE - 1`` others drawn from the seed."""
    n = min(n, len(cycle))
    first = int(np.argmax([cycle[i].out_frames for i in range(n)]))
    rest = [i for i in range(n) if i != first]
    rng = np.random.default_rng([int(seed) % 2**128, 13])
    drawn = rng.choice(len(rest), size=min(SAMPLE - 1, len(rest)), replace=False)
    return {first} | {rest[int(k)] for k in drawn}


def stated(req, inference: dict) -> dict:
    """What a call states to the program beside its inputs: the AR's cap
    (prompt + the call's frames + 1), the early-EOS estimate 50 tokens past
    it as a multiple of the characters (``eos_estimated_gen_length_factor``)
    and each row's estimate that gives, with every setting of the
    configuration's ``inference``. Prompts are counted in the stand-in
    tokenizer's ids: one a byte, with the two specials and, in a deep
    clone, the reference's frames."""
    prompts = []
    for text, tr, frames in zip(req.texts, req.transcripts, req.ref_frames):
        body = (tr + " " + text.strip()) if req.deep_clone else text.strip()
        prompts.append(len(body.encode("utf-8")) + 2 + (frames if req.deep_clone else 0))
    max_len = max(prompts) + req.out_frames + 1
    factor = (max_len - min(prompts) + 50) / min(len(t) for t in req.texts)
    return {"settings": dict(inference, timesteps=req.timesteps, deep_clone=req.deep_clone,
                             generate_max_len_override=max_len,
                             eos_estimated_gen_length_factor=factor),
            "est_lens": [round(factor * len(t)) for t in req.texts], "max_len": max_len}


def _prompt(text, transcript, codes_l0, deep):
    """The AR prompt the request states: [SOT] text bytes [EOT], the
    deep-clone transcript ahead of the text, then the reference's L0 codes as
    speech ids."""
    body = (transcript + " " + text.strip()) if deep else text.strip()
    ids = [SOT] + list(body.encode("utf-8")) + [EOT]
    if deep:
        ids += [TEXT_VOCAB + int(c) for c in codes_l0]
    return np.asarray(ids, np.int64)


def _f32(sd, device):
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}


HOME = Path(__file__).resolve().parent


def _route(kind: str, backend: str, home: Path = HOME):
    """The reference module of a route, ``<home>/reference/<kind>_<backend>.py``
    (home: the benchmark's folder), or None where there is none."""
    path = Path(home) / "reference" / f"{kind}_{backend}.py"
    if not path.exists():
        return None
    name = f"portbench.reference.{kind}_{backend}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sample(items, key, rng, n):
    """Up to ``n`` of ``items``: the one of largest ``key`` and the rest drawn."""
    if len(items) <= n:
        return list(items)
    items = sorted(items, key=key, reverse=True)
    rest = list(rng.choice(len(items) - 1, size=n - 1, replace=False) + 1)
    return [items[0]] + [items[i] for i in sorted(rest)]


def ar_rows(recs, rng):
    """(record, row) pairs of the compared calls' rows to teacher-force."""
    rows = [(r, i) for r in recs if r["kept"] and r["ar"] for i in range(len(r["ar"]))]
    return _sample(rows, lambda ri: ri[0]["ar"][ri[1]][1], rng, AR_ROWS)


def ar_miss(p, cfg, rows, device, control: bool, home: Path = HOME):
    """The share of the rows' served tokens the reference does not draw (for
    the control: of the tokens it draws in their place); inf where a prompt
    is not the one the request states or a row's uniforms were not
    recorded."""
    opts = cfg["options"]
    mod = _route("ar", opts.get("ar_backend", "bf16"), home)
    if mod is None:
        return float("inf")
    window = {"valid_start": TEXT_VOCAB,
              "valid_end": min(TEXT_VOCAB + SPEECH_VOCAB, cfg["ar"]["n_vocab"]), "eos_idx": EOS}
    prep = mod.prepare(p, cfg["ar"], opts)
    prep_c = mod.prepare(p, cfg["ar"], opts, control=True) if control else None
    miss = total = 0
    for rec, i in rows:
        req = rec["request"]
        st = stated(req, cfg["inference"])
        s = dict(st["settings"], **window)
        seq, n_gen = rec["ar"][i]
        codes = rec["codes"][i if len(rec["codes"]) > 1 else 0][0]          # (n_q, S)
        want = _prompt(req.texts[i], req.transcripts[i], codes[0].tolist(), req.deep_clone)
        prompt, served = seq[: len(seq) - n_gen], seq[len(seq) - n_gen:]
        if not np.array_equal(prompt, want) or rec["u"] is None or n_gen < 1:
            return float("inf")
        dev = lambda a: torch.as_tensor(np.asarray(a), device=device)
        spk, served_t = codes.t().to(device), dev(served)
        k = torch.arange(n_gen).clamp_max(st["max_len"] - 1)
        u = rec["u"][k, i].to(device)
        est = st["est_lens"][i]
        logits = mod.served_logits(prep, cfg["ar"], dev(prompt), spk, served_t)
        drawn = [sampling.draw(sampling.logprobs(logits, served_t, s, est, widen), u)
                 for widen in (-1, 0, 1)]
        got = served_t
        if control:
            ctl = mod.served_logits(prep_c, cfg["ar"], dev(prompt), spk, served_t)
            got = sampling.draw(sampling.logprobs(ctl, served_t, s, est), u)
        miss += int(((got != drawn[0]) & (got != drawn[1]) & (got != drawn[2])).sum())
        total += n_gen
        del logits
    return miss / total if total else float("inf")


def _batch(nar, device):
    c_text, c_codes, ctl, ccl, _, _ = nar["batch"]
    t = lambda a: torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a),
                                  device=device).long()
    return {"c_text": t(c_text), "c_codes": t(c_codes), "ctl": t(ctl), "ccl": t(ccl)}


def guidance_kept(recs, cfg) -> bool:
    """Every call ran T reverse steps, each over the rows the guidance
    interval states: twice the batch on the CFG steps, the batch on the
    others."""
    w = cfg["inference"]["nar_guidance_w"]
    interval = cfg["options"].get("guidance_interval", (0.0, 1.0))
    for rec in recs:
        nar, T = rec["nar"], rec["request"].timesteps
        if nar is None or nar["T"] != T or len(nar["rows"]) != T:
            return False
        bs = len(rec["request"].texts)
        for i, rows in enumerate(nar["rows"]):
            t = T - 1 - i
            if rows != (2 * bs if w != 1 and guided(t, T, interval) else bs):
                return False
    return True


def nar_gap(p, cfg, recs, device, control: bool, home: Path = HOME):
    """The widest score gap over the kept reverse steps of the compared calls
    ``recs``; inf where a step ran other rows than the guidance interval
    states (``guidance_kept``, over every call) or a compared call kept no
    step."""
    mod = _route("nar", cfg["options"].get("nar_backend", "bf16"), home)
    kept = [r for r in recs if r["kept"]]
    if mod is None or not kept or not guidance_kept(recs, cfg):
        return float("inf")
    inf = cfg["inference"]
    w, temp = float(inf["nar_guidance_w"]), float(inf["x_0_temp"])
    interval = cfg["options"].get("guidance_interval", (0.0, 1.0))
    q = mod.prepare(p, cfg["nar"], cfg["options"])
    qc = mod.prepare(p, cfg["nar"], cfg["options"], control=True) if control else None
    worst = 0.0
    for rec in kept:
        nar, T = rec["nar"], rec["request"].timesteps
        if not nar["steps"]:
            return float("inf")
        tables = Tables(cfg["nar"]["n_quant"], T)
        batch = _batch(nar, device)
        for st in nar["steps"]:
            step = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in st.items()}
            step["x"], step["x_t"] = step["x"].long(), step["x_t"].long()
            s = {"guided": w != 1 and guided(step["t"], T, interval), "batched": w != 1,
                 "w": w, "temp": temp}
            sc = mod.step_scores(q, cfg["nar"], step, batch, tables, s)
            k = step["out"].long()
            if control:
                k = mod.step_scores(qc, cfg["nar"], step, batch, tables, s).argmax(dim=-1)
            gap = sc.max(dim=-1).values - sc.gather(-1, k[..., None])[..., 0]
            valid = ~step["xpm"][:, step["offset"]:].bool()
            worst = max(worst, float(gap[valid].max()))
            del sc, gap
    return worst


def codes_diff(p, cfg, recs, device, control: bool):
    """The share of differing codes over the references of the compared calls."""
    diff = total = 0
    with _tf32(control):
        for rec in recs:
            if not rec["kept"]:
                continue
            for ref, got in zip(rec["request"].refs, rec["codes"]):
                want = ref_codec.encodec_codes(p, cfg["encodec"],
                                               torch.as_tensor(ref, device=device))
                got = got[0].to(device)
                diff += int((want != got).sum())
                total += want.numel()
    return diff / total if total else float("inf")


def audio_err(p, cfg, recs, device, control: bool):
    """The largest difference of the program's Vocos audio from the
    reference's, over the reference's peak, for the compared calls' grids."""
    worst, seen = 0.0, 0
    with _tf32(control):
        for rec in recs:
            if not rec["kept"] or rec["audio"] is None or rec["grid"] is None:
                continue
            grid = rec["grid"].to(device).long()
            grid = grid[None] if grid.ndim == 2 else grid
            want = ref_codec.vocos_audio(p, cfg["vocos"], grid)
            got = rec["audio"].to(device).float().reshape(want.shape)
            worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp_min(1e-6)))
            seen += 1
    return worst if seen else float("inf")


class _tf32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old


def compare(recs, cfg, seed: int, device, control: bool = False, home: Path = HOME) -> dict:
    """{number: value} of the program (or of the control) over ``recs``, the
    window's finished calls. The reference regenerates the seed's weights;
    each route's module is found under ``home`` (the benchmark's folder)."""
    rng = np.random.default_rng([int(seed) % 2**128, 17])
    sds = weights.states(cfg, seed, device)
    out = {}
    rows = ar_rows(recs, rng)
    p = _f32(sds.pop("ar"), device)
    out["ar_miss"] = ar_miss(p, cfg, rows, device, control, home) if rows else float("inf")
    del p
    p = _f32(sds.pop("nar"), device)
    out["nar_gap"] = nar_gap(p, cfg, recs, device, control, home)
    del p
    p = _f32(sds.pop("encodec"), device)
    out["codes_diff"] = codes_diff(p, cfg, recs, device, control)
    p = _f32(sds.pop("vocos"), device)
    out["audio_err"] = audio_err(p, cfg, recs, device, control)
    return out
