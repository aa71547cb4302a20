"""The closed-loop generator: a fixed cycle of requests that one client sends
one after the other, the next when the last returns (one ``Predictor``
instance's traffic).

Parameters (a mix's JSON): ``entry`` ("tts" or "tts_batch"), ``rows`` (texts
a call; 1 for ``tts``), ``deep_clone``, ``ref_seconds`` [lo, hi] (uniform),
``out_seconds`` ({"dist": "lognormal", "median", "sigma", "clip": [lo, hi]}
or {"dist": "uniform", "range": [lo, hi]}), ``strata`` (calls in the
cycle), ``chars_per_second`` (text per second of speech), ``timesteps``,
``trace_calls`` (the calls a traced run's window holds). Every call samples
with the settings its configuration's ``inference`` states.

The lengths are the distribution's quantiles at the strata's midpoints, and
the cycle alternates the shortest and the longest left (shortest first):
every seed sends the same sizes in the same order, so a window of a given
length holds the same work whatever the seed. The seed draws the texts, the
reference audio and every call's sampling seed. A reference is white noise
at 0.1 RMS, a whole number of 320-sample frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

WORDS = ("the", "a", "voice", "river", "market", "quiet", "seven", "morning", "light",
         "station", "paper", "garden", "over", "under", "slowly", "bright", "number",
         "window", "answer", "travel", "winter", "silver", "letter", "between", "north")


@dataclass
class Request:
    """One call: ``texts`` with a reference each (``refs``, float32 audio) and
    its transcript (empty for a shallow clone), the AR's cap on generated
    frames, and its sampling seed."""

    texts: list
    refs: list
    transcripts: list
    out_frames: int
    seed: int
    deep_clone: bool
    timesteps: int
    ref_frames: list = field(default_factory=list)


def _quantiles(spec: dict, n: int) -> list[float]:
    mids = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        lo, hi = spec["range"]
        return [lo + (hi - lo) * m for m in mids]
    lo, hi = spec["clip"]
    z = NormalDist()
    return [min(max(spec["median"] * math.exp(spec["sigma"] * z.inv_cdf(m)), lo), hi)
            for m in mids]


def _text(rng, n_chars: int) -> str:
    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    return " ".join(words)[:max(n_chars, 1)].strip() or "a"


def _alternate(n: int) -> list[int]:
    """0, n-1, 1, n-2, ...: shortest and longest in turn."""
    lo, hi, out = 0, n - 1, []
    while lo <= hi:
        out.append(lo)
        if hi != lo:
            out.append(hi)
        lo, hi = lo + 1, hi - 1
    return out


def requests(params: dict, seed: int, sample_rate: int = 24000, hop: int = 320,
             frame_rate: float = 75.0) -> list[Request]:
    """The cycle of calls of run ``seed``."""
    rng = np.random.default_rng([int(seed) % 2**128, 11])
    n = int(params["strata"])
    rows = int(params.get("rows", 1))
    outs = _quantiles(params["out_seconds"], n)
    lo, hi = params["ref_seconds"]
    order = _alternate(n)
    cps = float(params["chars_per_second"])
    deep = bool(params["deep_clone"])
    out = []
    for i in order:
        out_frames = max(int(round(outs[i] * frame_rate)), 2)
        texts, refs, trs, ref_frames = [], [], [], []
        for r in range(rows):
            # each row its own reference length, spread over the range
            q = ((i * rows + r) % (n * rows) + 0.5) / (n * rows)
            ref_s = lo + (hi - lo) * q
            frames = max(int(round(ref_s * frame_rate)), 1)
            refs.append((rng.standard_normal(frames * hop) * 0.1).astype(np.float32))
            ref_frames.append(frames)
            texts.append(_text(rng, int(round(outs[i] * cps))))
            trs.append(_text(rng, int(round(frames / frame_rate * cps))) if deep else "")
        out.append(Request(texts=texts, refs=refs, transcripts=trs, out_frames=out_frames,
                           seed=int(rng.integers(2**31)), deep_clone=deep,
                           timesteps=int(params.get("timesteps", 200)), ref_frames=ref_frames))
    return out


def largest(params: dict, seed: int, **kw) -> Request:
    """The warm-up call: the cycle's longest output, with its texts, and its
    longest references, at the cycle's own T (it grows every buffer and
    cache the window's calls use)."""
    reqs = requests(params, seed, **kw)
    long = max(reqs, key=lambda r: r.out_frames)
    longest_refs = max(reqs, key=lambda r: max(r.ref_frames))
    return Request(texts=long.texts, refs=longest_refs.refs,
                   transcripts=longest_refs.transcripts, out_frames=long.out_frames,
                   seed=long.seed + 1, deep_clone=long.deep_clone,
                   timesteps=long.timesteps, ref_frames=longest_refs.ref_frames)
