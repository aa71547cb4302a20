"""Logit processors and categorical draws (``mars5_tts_tpu/ops/sampling.py``).

Draws take their uniforms as arguments: inverse-CDF for the AR, Gumbel-max
for the diffusion. Given the same uniforms, both packages pick the same ids.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
MIN_LOG_ARG = 1e-7  # the reference diffuser's clamp


def top_k_sorted(logits, k: int):
    """The k largest values per row, descending, ties lowest index first
    (``jax.lax.top_k``'s order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def freq_presence_penalty(logits, counts, alpha_frequency: float,
                          alpha_presence: float):
    """``logits - counts*a_freq - (counts > 0)*a_presence``."""
    c = counts.to(logits.dtype)
    return logits - c * alpha_frequency - (c > 0).to(logits.dtype) * alpha_presence


def early_eos_penalty(logits, n_generated, estimated_gen_length, decay, factor,
                      eos_index: int):
    """Subtract ``factor * max(est - n, 1)**decay`` (f32) from each row's EOS
    logit while its ``n_generated <= estimated_gen_length``; ``n_generated``,
    ``estimated_gen_length``, ``decay`` and ``factor`` are scalars or (B,)
    host arrays. Each row's modifier is computed on its own, with the row's
    decay a Python scalar (PyTorch's ``pow`` by a scalar 0.5 rounds unlike
    ``pow`` by a tensor)."""
    shape = logits.shape[:1]
    n = np.broadcast_to(np.asarray(n_generated, np.int64), shape)
    est = np.broadcast_to(np.asarray(estimated_gen_length, np.int64), shape)
    decay = np.broadcast_to(np.asarray(decay, np.float64), shape)
    factor = np.broadcast_to(np.asarray(factor, np.float64), shape)
    apply = n <= est
    if not apply.any():
        return logits
    logits = logits.clone()
    for i in np.flatnonzero(apply):     # a host scalar a row: no host-to-device copy
        pen = torch.as_tensor(np.maximum(est[i:i + 1] - n[i:i + 1], 1), dtype=torch.float32)
        modifier = (float(factor[i]) * pen ** float(decay[i])).to(logits.dtype)
        logits[int(i), eos_index] -= modifier[0].item()
    return logits


def early_eos_table(estimated_gen_length: int, decay: float, factor: float, n: int):
    """(n + 1,) f32: what ``early_eos_penalty`` subtracts from a row's EOS
    logit at each generated count 0..n, 0 past ``estimated_gen_length``, each
    value bit for bit its own. The base sits in a strided view: PyTorch's CPU
    ``pow`` then takes its scalar path for every element, as for the
    one-element tensor of ``early_eos_penalty`` (its vectorized path rounds
    otherwise)."""
    k = np.arange(n + 1)
    pen = torch.empty(2 * (n + 1), dtype=torch.float32)[::2]
    pen.copy_(torch.from_numpy(np.maximum(estimated_gen_length - k, 1).astype(np.float32)))
    modifier = float(factor) * pen ** float(decay)
    return torch.where(torch.from_numpy(k <= estimated_gen_length), modifier, 0.0)


def mask_vocab_window(logits, valid_start: int, valid_end: int):
    """-inf outside ``[valid_start - 1, valid_end)`` (the reference's slicing,
    which leaves index ``valid_start - 1`` allowed)."""
    idx = torch.arange(logits.shape[-1], device=logits.device)
    keep = (idx >= valid_start - 1) & (idx < valid_end)
    return logits.masked_fill(~keep[None, :], NEG_INF)


def filter_topk_subset(logits, top_k: int, top_p: float = 1.0,
                       typical_mass: float = 1.0, min_tokens: int = 1):
    """Top-k, then nucleus, then typical filtering on the sorted top-k subset,
    scattered back to the full vocabulary (others -inf). Requires top_k > 0."""
    if top_k <= 0:
        raise ValueError("filter_topk_subset needs top_k > 0")
    k = min(max(top_k, min_tokens), logits.shape[-1])
    vals, idx = top_k_sorted(logits, k)

    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        remove = cum > top_p
        if min_tokens > 1:
            remove[..., :min_tokens] = False
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        vals = vals.masked_fill(remove, NEG_INF)

    if typical_mass <= 0.999:
        normalized = torch.log_softmax(vals, dim=-1)
        p = torch.exp(normalized)
        prod = torch.where(torch.isneginf(normalized), 0.0, normalized * p)
        ent = -prod.sum(dim=-1, keepdim=True)
        shifted = (-normalized - ent).abs()
        order = torch.argsort(shifted, dim=-1, stable=True)
        sorted_scores = torch.gather(shifted, -1, order)
        sorted_vals = torch.gather(vals, -1, order)
        cum = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
        last_ind = (cum < typical_mass).sum(dim=-1, keepdim=True)
        threshold = torch.gather(sorted_scores, -1, last_ind)
        vals = vals.masked_fill(shifted > threshold, NEG_INF)

    return torch.full_like(logits, NEG_INF).scatter(-1, idx, vals)


def filter_topk_subset_rows(logits, max_k: int, k_row=None, top_p_row=None, typical_row=None,
                            min_tokens: int = 1):
    """``filter_topk_subset`` with each row's own k (at most the extraction
    width ``max_k``), top-p and typical mass: ``k_row`` (B,) int64,
    ``top_p_row`` and ``typical_row`` (B,) f32 on the logits' device. A row
    with top_p >= 1 or typical mass > 0.999 leaves that filter off, so a row
    whose values are the static ones gets the static path's result. None in
    place of one of them skips its block: every row at ``max_k``, or no row
    with that filter on (the caller knows from its host values)."""
    if max_k <= 0:
        raise ValueError("filter_topk_subset_rows needs max_k > 0")
    k = min(max(max_k, min_tokens), logits.shape[-1])
    vals, idx = top_k_sorted(logits, k)
    if k_row is not None:
        pos = torch.arange(k, device=logits.device)[None, :]
        vals = vals.masked_fill(pos >= k_row.clamp_min(min_tokens)[:, None], NEG_INF)

    if top_p_row is not None:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        remove = cum > top_p_row[:, None]
        if min_tokens > 1:
            remove[..., :min_tokens] = False
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        vals = vals.masked_fill(remove & (top_p_row[:, None] < 1.0), NEG_INF)

    if typical_row is not None:
        normalized = torch.log_softmax(vals, dim=-1)
        p = torch.exp(normalized)
        prod = torch.where(torch.isneginf(normalized), 0.0, normalized * p)
        ent = -prod.sum(dim=-1, keepdim=True)
        shifted = (-normalized - ent).abs()
        order = torch.argsort(shifted, dim=-1, stable=True)
        sorted_scores = torch.gather(shifted, -1, order)
        sorted_vals = torch.gather(vals, -1, order)
        cum_t = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
        # a row whose mass is never reached keeps every value (JAX's
        # out-of-range gather gives no threshold there either)
        last_ind = (cum_t < typical_row[:, None]).sum(dim=-1, keepdim=True).clamp_max(k - 1)
        threshold = torch.gather(sorted_scores, -1, last_ind)
        vals = vals.masked_fill((shifted > threshold) & (typical_row[:, None] <= 0.999),
                                NEG_INF)

    return torch.full_like(logits, NEG_INF).scatter(-1, idx, vals)


def top_k_top_p_filter(logits, top_k: int = 0, top_p: float = 1.0,
                       min_tokens: int = 1):
    """Full-vocabulary top-k then nucleus filtering; ties with the k-th value
    survive."""
    v = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, min_tokens), v)
        kth = top_k_sorted(logits, k)[0][..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                               stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum > top_p
        if min_tokens > 1:
            remove[..., :min_tokens] = False
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        remove_orig = torch.zeros_like(remove).scatter(-1, sorted_idx, remove)
        logits = logits.masked_fill(remove_orig, NEG_INF)
    return logits


def apply_typical_p(logits, mass: float):
    """Typical sampling (arXiv 2202.00666) over the full vocabulary; no-op when
    ``mass > 0.999``."""
    if mass > 0.999:
        return logits
    normalized = torch.log_softmax(logits, dim=-1)
    p = torch.exp(normalized)
    prod = torch.where(torch.isneginf(normalized), 0.0, normalized * p)
    ent = -prod.sum(dim=-1, keepdim=True)
    shifted = (-normalized - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_scores = torch.gather(shifted, -1, order)
    sorted_logits = torch.gather(logits, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_scores, -1, last_ind)
    remove_sorted = sorted_scores > threshold
    remove = torch.zeros_like(remove_sorted).scatter(-1, order, remove_sorted)
    return logits.masked_fill(remove, NEG_INF)


def sample_from_logprobs(logprobs, u):
    """Inverse-CDF draw: logprobs (bs, V), u (bs,) in [0, 1) -> (bs,) int64.

    The float cumsum can wobble inside a run of zero-probability entries, so
    the raw index is snapped to the first live (finite) index at or after it,
    or the last live index when it ran past the end. A row with no live
    entry raises, but not while a CUDA graph captures the draw (the check
    reads the device): there such a row draws -1, and the caller checks.
    """
    cdf = torch.cumsum(torch.exp(logprobs), dim=-1)
    r = u[..., None] * cdf[..., -1:]
    raw = (cdf <= r).sum(dim=-1)
    v = logprobs.shape[-1]
    idx = torch.arange(v, device=logprobs.device)
    live = torch.isfinite(logprobs)
    capturing = logprobs.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing and not bool(live.any(dim=-1).all()):
        raise ValueError("sample_from_logprobs: a row has no finite logprob")
    at_or_after = torch.where(live & (idx >= raw[..., None]), idx, v).amin(dim=-1)
    last_live = torch.where(live, idx, -1).amax(dim=-1)
    return torch.where(at_or_after < v, at_or_after, last_live)


def gumbel_argmax(logprobs, uniform, dim: int = -1):
    """``argmax(-log(-log(clamp(u))) + logprobs)`` with the 1e-7 clamps."""
    g = -torch.log(torch.clamp(-torch.log(torch.clamp(uniform, min=MIN_LOG_ARG)),
                               min=MIN_LOG_ARG))
    return torch.argmax(g + logprobs, dim=dim)
