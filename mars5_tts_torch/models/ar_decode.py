"""KV-cached AR generation over one or more rows
(counterpart of ``mars5_tts_tpu/models/ar_decode.py``: ``ar_generate`` and
``ar_generate_batched``).

Prefill over each row's prompt, then one token a row per step through
a ring cache of ``window = min(sliding_window, max_len + 1)`` slots written
at ``position % window``. For a row at position p, slot s holds position
``p - ((p - s) mod window)``; negative positions (never written, or prompt
padding ahead of the cursor) and the current token's own stale slot are
masked, and the current token attends to itself through an explicit extra
column: kernel K7 (``ops/kernels/decode_attention``) on the card, its plain
twin on the CPU. Position 0 is the speaker vector; token i sits at position
i + 1.

Each row carries its own prompt length, cursor, generated count, penalty
counts, early-EOS length estimate and done flag (the JAX ``DecodeState``).
A done row appends nothing and stops counting; the loop ends when every row
is done. Like the JAX engine, every decode step runs all rows (a done row at
its frozen position); rows never read each other, so the live rows' tokens
are those of their solo runs.

Randomness is an explicit (max_len, rows) stream of uniforms, row i's k-th
generated token consuming ``uniforms[k, i]``, or one drawn from a seeded
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.attention import linear
from ..ops.kernels.decode_attention import decode_attention
from ..ops.rope import rope_angles
from ..ops.sampling import (apply_typical_p, early_eos_penalty, filter_topk_subset,
                            freq_presence_penalty, mask_vocab_window,
                            sample_from_logprobs, top_k_top_p_filter)
from ..utils.device import ints_on_device
from .ar import CodecLM


def ar_vocab_window(n_text_vocab: int, n_speech_vocab: int,
                    n_model_vocab: int) -> tuple[int, int]:
    """(valid_start, valid_end) of the speech-token window, the end clamped to
    the model's vocabulary so ids past ``text + speech`` are never sampled."""
    return n_text_vocab, min(n_text_vocab + n_speech_vocab, n_model_vocab)


@dataclass(frozen=True)
class ArSampling:
    """Sampling hyperparameters for one generation."""

    temperature: float = 0.7
    top_k: int = 200
    top_p: float = 0.2
    typical_p: float = 1.0
    alpha_frequency: float = 3.0
    alpha_presence: float = 0.4
    penalty_window: int = 80
    eos_penalty_decay: float = 0.5
    eos_penalty_factor: float = 1.0
    n_phones_gen: int = 0
    eos_idx: int = 0
    valid_start: int = 0
    valid_end: int = 0
    max_len: int = 2000           # max total sequence length (prompt + generated)


def filter_logits(logits, s: ArSampling, counts, n_gen, est_len):
    """The per-step logit pipeline over rows: penalties (rows past their
    second generated token), vocab window, early-EOS, temperature,
    top-k/top-p/typical-p, window again, log-softmax. logits (B, V) f32;
    counts (B, V); n_gen and est_len (B,) host arrays."""
    penalize = np.asarray(n_gen) > 1
    if penalize.any():
        pen = freq_presence_penalty(logits, counts, s.alpha_frequency, s.alpha_presence)
        logits = pen if penalize.all() else torch.where(
            ints_on_device(penalize, logits.device, torch.bool)[:, None], pen, logits)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    logits = early_eos_penalty(logits, n_gen, est_len, s.eos_penalty_decay,
                               s.eos_penalty_factor, s.eos_idx)
    logits = logits / s.temperature
    if s.top_k > 0:
        logits = filter_topk_subset(logits, s.top_k, s.top_p, s.typical_p)
    else:
        logits = apply_typical_p(top_k_top_p_filter(logits, 0, s.top_p), s.typical_p)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    return torch.log_softmax(logits, dim=-1)


class RingCache:
    """Per-layer (B, W, H, D) key/value rings of B rows: (L, B, W, H, D)."""

    def __init__(self, n_layers: int, batch: int, window: int, n_heads: int,
                 head_dim: int, dtype, device):
        self.window = window
        self.k = torch.zeros((n_layers, batch, window, n_heads, head_dim), dtype=dtype,
                             device=device)
        self.v = torch.zeros_like(self.k)


@torch.no_grad()
def decode_step(model: CodecLM, tokens, pos, cache: RingCache):
    """Feed ``tokens`` (B,) at positions ``pos`` (B,) through every layer;
    returns f32 logits (B, V) and writes each row's k/v into its slot
    ``pos % window``."""
    cfg = model.cfg
    dev = cache.k.device
    rows = torch.arange(len(tokens), device=dev)
    pos_t = ints_on_device(pos, dev, torch.int32)
    x = torch.stack([model.embed.weight[int(t)] for t in tokens])[:, None]
    cos, sin = rope_angles(pos_t, cfg.head_dim)
    cos, sin = cos[:, None, None], sin[:, None, None]        # (B, 1, 1, D/2)
    slots = torch.remainder(pos_t.long(), cache.window)
    top = max(np.asarray(pos).reshape(-1).tolist())        # sizes K7's clusters
    for li, layer in enumerate(model.ar.layers):
        q, k, v = layer.qkv(x, cos, sin)
        attn = decode_attention(q[:, 0], cache.k[li], cache.v[li], pos_t, k[:, 0], v[:, 0],
                                max_pos=top)
        cache.k[li, rows, slots] = k[:, 0]
        cache.v[li, rows, slots] = v[:, 0]
        x = layer.finish(x, attn[:, None])
    logits = linear(model.ar.norm(x), model.ar.output.weight)[:, 0]
    return logits.float()


def uniform_stream(uniforms, generator, seed: int, n: int, rows: int, device):
    """The AR's (n, rows) uniforms: the given ones (a 1-D stream is one
    row's), or drawn on ``device`` from ``generator`` (or one seeded with
    ``seed``)."""
    if uniforms is not None:
        u = np.asarray(uniforms, np.float32)
        return torch.as_tensor(u.reshape(-1, 1) if u.ndim == 1 else u, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, rows), generator=generator, device=device)


def prefill_rows(model: CodecLM, prompts, spk_codes_list, window: int):
    """Prefill each prompt (1-D ids) with its speaker vector of
    ``spk_codes_list`` (S_i, 8), one row at a time at its own length, so a
    row's first logits and prompt K/V are those of its solo run bit for bit
    (a padded batch sums over other lengths and rounds otherwise now and
    then; the JAX engine pads every row to one 64-wide bucket). Returns (the
    (B, V) f32 logits at each row's last prompt token, one list of
    per-layer (k, v), each (1, P_i + 1, H, D), a row)."""
    if max(len(p) for p in prompts) + 1 > window:
        raise ValueError(f"prompt {max(len(p) for p in prompts)}+1 exceeds cache window "
                         f"{window}")
    dev = model.embed.weight.device
    logits, kvs = [], []
    for p, spk in zip(prompts, spk_codes_list):
        spk = torch.as_tensor(np.asarray(spk, np.int64), device=dev)[None]
        all_logits, kv = model.prefill(torch.as_tensor(np.asarray(p, np.int64), device=dev)[None],
                                       model.spk_embedding(spk))
        logits.append(all_logits[:, len(p)].float())
        kvs.append(kv)
    return torch.cat(logits), kvs


def sample_rows(logits, prompts, s: ArSampling, uniforms, step, est_lens=None):
    """The decode loop shared by the AR engines, over B rows: sample from
    ``logits`` (B, V), row i's k-th generated token consuming
    ``uniforms[min(k, max_len - 1), i]``, update each row's state (the JAX
    ``_sample_and_update``), then ``step(tokens (B,), positions (B,))`` gives
    the next logits, until every row is done. Returns one (sequence incl.
    the prompt and without the closing EOS, n_generated) per row."""
    b = len(prompts)
    rows = np.arange(b)
    tokens = np.zeros((b, s.max_len), np.int64)
    cur = np.zeros(b, np.int64)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
        cur[i] = len(p)
    n_gen = np.zeros(b, np.int64)
    done = np.zeros(b, bool)
    est = np.full(b, s.n_phones_gen, np.int64) if est_lens is None else np.asarray(est_lens)
    counts = torch.zeros((b, logits.shape[-1]), dtype=torch.int32, device=logits.device)
    while True:
        logprobs = filter_logits(logits, s, counts, n_gen, est)
        k = np.minimum(n_gen, s.max_len - 1)
        u = torch.stack([uniforms[int(k[i]), i] for i in range(b)])
        tok = sample_from_logprobs(logprobs, u).cpu().numpy()
        active = ~done
        appends = active & (tok != s.eos_idx) & (cur < s.max_len)
        at = np.minimum(cur, s.max_len - 1)
        tokens[rows, at] = np.where(appends, tok, tokens[rows, at])
        evict_pos = cur - s.penalty_window          # the token leaving the window
        evict = appends & (n_gen + 1 > s.penalty_window) & (evict_pos >= 0)
        evict_tok = tokens[rows, np.clip(evict_pos, 0, s.max_len - 1)]
        # host ints index the counts, one small op a row: an index tensor would
        # cost a host-to-device copy a step
        for i in np.flatnonzero(appends):
            counts[int(i), int(tok[i])] += 1
        for i in np.flatnonzero(evict):
            counts[int(i), int(evict_tok[i])] -= 1
        cur = cur + appends
        n_gen = n_gen + appends
        done = done | (active & (tok == s.eos_idx)) | (cur >= s.max_len)
        if done.all():
            break
        logits = step(tokens[rows, np.maximum(cur - 1, 0)], cur)
    return [(tokens[i, : cur[i]].copy(), int(n_gen[i])) for i in range(b)]


@torch.no_grad()
def ar_generate_batched(model: CodecLM, prompts, spk_codes_list, *, sampling: ArSampling,
                        uniforms=None, generator: torch.Generator | None = None,
                        seed: int = 0, est_lens=None):
    """Complete each of ``prompts`` (1-D token ids) conditioned on its
    ``spk_codes_list`` entry (S_i, 8). Returns one (np.ndarray sequence incl.
    the prompt and without the closing EOS, n_generated) per row.

    ``uniforms`` (max_len, B): row i's k-th generated token consumes
    ``uniforms[k, i]``; without it the stream is drawn on the model's device
    from ``generator`` (or one seeded with ``seed``). ``est_lens`` (B,): each
    row's early-EOS length estimate (default ``sampling.n_phones_gen``).
    Each row's prompt fills the first ``P_i + 1`` slots of its ring; the
    slots past them stay masked (their position is negative) until the row's
    own tokens overwrite them.
    """
    s = sampling
    cfg = model.cfg
    dev = model.embed.weight.device
    prompts = [np.asarray(p, np.int64) for p in prompts]
    window = min(cfg.sliding_window, s.max_len + 1)
    logits, kvs = prefill_rows(model, prompts, spk_codes_list, window)
    uniforms = uniform_stream(uniforms, generator, seed, s.max_len, len(prompts), dev)
    cache = RingCache(cfg.n_layers, len(prompts), window, cfg.n_kv_heads, cfg.head_dim,
                      kvs[0][0][0].dtype, dev)
    for r, row in enumerate(kvs):
        for li, (k, v) in enumerate(row):
            cache.k[li, r, : k.shape[1]] = k[0]
            cache.v[li, r, : v.shape[1]] = v[0]
    return sample_rows(logits, prompts, s, uniforms,
                       lambda t, pos: decode_step(model, t, pos, cache), est_lens)


def ar_generate(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                uniforms=None, generator: torch.Generator | None = None, seed: int = 0):
    """Complete one ``prompt`` (1-D token ids) conditioned on ``spk_codes``
    (S, 8): ``ar_generate_batched`` with one row, the k-th generated token
    consuming ``uniforms[k]``. Returns (np.ndarray sequence incl. the prompt
    and without the closing EOS, n_generated)."""
    return ar_generate_batched(model, [prompt], [spk_codes], sampling=sampling,
                               uniforms=uniforms, generator=generator, seed=seed)[0]
