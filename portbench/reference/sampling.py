"""The AR's draw of each served token from its logits, teacher-forced: the
MARS5 release's sampler as the request states it, in float32.

Per generated token k of a row (``mars5_tts_torch/models/ar_decode.py:144-175``
``filter_logits`` and ``:239-266`` ``sample_update``; ``ops/sampling.py``):
the frequency and presence penalties over the row's last
``rep_penalty_window`` generated tokens (from k = 2 on), the vocabulary
window, the early-EOS penalty while k <= the row's length estimate, the
temperature, top-k (a stable descending sort), nucleus filtering on the
sorted top-k, the window again, log-softmax; then the inverse-CDF draw on
the row's uniform of token k (``ops/sampling.py:167-186``
``sample_from_logprobs``).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def window_counts(served, n_vocab: int, window: int):
    """(N, V) int: the count of each id among the ``window`` served tokens
    before each position."""
    n = served.shape[0]
    onehot = torch.zeros(n + 1, n_vocab, dtype=torch.int32, device=served.device)
    onehot[torch.arange(1, n + 1, device=served.device), served] = 1
    cum = torch.cumsum(onehot, dim=0)                     # cum[k]: served[:k]
    k = torch.arange(n, device=served.device)
    return cum[k] - cum[(k - window).clamp_min(0)]


def logprobs(logits, served, s: dict, est_len: int, widen: int = 0):
    """The filtered log-probabilities (N, V) that draw each of the N
    ``served`` tokens from its ``logits`` (N, V) float32. ``s``: the
    request's sampling settings and the vocabulary window (``temperature``,
    ``top_k``, ``top_p``, ``freq_penalty``, ``presence_penalty``,
    ``rep_penalty_window``, ``eos_penalty_decay``, ``eos_penalty_factor``,
    ``valid_start``, ``valid_end``, ``eos_idx``). ``widen``: the nucleus
    keeps that many more of the top-k (fewer where negative; at least one,
    at most k) than top-p gives it: the draws of a nucleus whose last member
    is in or out by rounding."""
    n, v = logits.shape
    dev = logits.device
    c = window_counts(served, v, int(s["rep_penalty_window"])).float()
    pen = logits - c * s["freq_penalty"] - (c > 0).float() * s["presence_penalty"]
    k = torch.arange(n, device=dev)
    z = torch.where((k > 1)[:, None], pen, logits)
    idx = torch.arange(v, device=dev)
    keep = (idx >= s["valid_start"] - 1) & (idx < s["valid_end"])
    z = z.masked_fill(~keep[None], NEG_INF)
    left = torch.clamp(est_len - k, min=1).float()
    eos = (s["eos_penalty_factor"] * left ** s["eos_penalty_decay"]).float()
    z[:, s["eos_idx"]] -= torch.where(k <= est_len, eos, torch.zeros_like(eos))
    z = z / torch.tensor(s["temperature"], dtype=torch.float32, device=dev)
    top = min(int(s["top_k"]), v)
    vals, ids = torch.sort(z, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :top], ids[:, :top]
    if s["top_p"] < 1.0:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        drop = cum > torch.tensor(s["top_p"], dtype=torch.float32, device=dev)
        drop = torch.cat([torch.zeros_like(drop[:, :1]), drop[:, :-1]], dim=-1)
        if widen:
            kept = (~drop).sum(dim=-1, keepdim=True) + widen
            drop = torch.arange(top, device=dev)[None] >= kept.clamp(1, top)
        vals = vals.masked_fill(drop, NEG_INF)
    z = torch.full_like(z, NEG_INF).scatter(-1, ids, vals)
    z = z.masked_fill(~keep[None], NEG_INF)
    return torch.log_softmax(z, dim=-1)


def draw(lp, u):
    """The inverse-CDF draw of each row of ``lp`` (N, V) on its uniform ``u``
    (N,): the first id whose cumulative probability passes ``u`` times the
    total, moved to the first live id at or after it (the last live id past
    the end)."""
    cdf = torch.cumsum(torch.exp(lp), dim=-1)
    raw = (cdf <= u[:, None] * cdf[:, -1:]).sum(dim=-1)
    v = lp.shape[-1]
    idx = torch.arange(v, device=lp.device)
    live = torch.isfinite(lp)
    after = torch.where(live & (idx >= raw[:, None]), idx, v).amin(dim=-1)
    last = torch.where(live, idx, -1).amax(dim=-1)
    return torch.where(after < v, after, last)
