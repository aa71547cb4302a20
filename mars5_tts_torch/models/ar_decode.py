"""KV-cached AR generation at batch size 1
(counterpart of ``mars5_tts_tpu/models/ar_decode.py``, bs=1 path).

Prefill over the prompt, then one token per step through a ring cache of
``window = min(sliding_window, max_len + 1)`` slots written at
``position % window``. For a step at position p, slot s holds position
``p - ((p - s) mod window)``; negative positions (never written) and the
current token's own stale slot are masked, and the current token attends to
itself through an explicit extra column. Position 0 is the speaker vector;
token i sits at position i + 1.

Randomness is an explicit stream of uniforms, one per generated token
(``uniforms``), or drawn from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.attention import linear
from ..ops.rope import rope_angles
from ..ops.sampling import (apply_typical_p, early_eos_penalty, filter_topk_subset,
                            freq_presence_penalty, mask_vocab_window,
                            sample_from_logprobs, top_k_top_p_filter)
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


def filter_logits(logits, s: ArSampling, counts, n_gen: int):
    """The per-step logit pipeline: penalties (after the second generated
    token), vocab window, early-EOS, temperature, top-k/top-p/typical-p,
    window again, log-softmax. logits (1, V) f32."""
    if n_gen > 1:
        logits = freq_presence_penalty(logits, counts, s.alpha_frequency,
                                       s.alpha_presence)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    logits = early_eos_penalty(logits, n_gen, s.n_phones_gen, s.eos_penalty_decay,
                               s.eos_penalty_factor, s.eos_idx)
    logits = logits / s.temperature
    if s.top_k > 0:
        logits = filter_topk_subset(logits, s.top_k, s.top_p, s.typical_p)
    else:
        logits = apply_typical_p(top_k_top_p_filter(logits, 0, s.top_p), s.typical_p)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    return torch.log_softmax(logits, dim=-1)


def decode_attention(q, ck, cv, pos: int, k_new, v_new):
    """One token's attention over the ring cache plus its own column.

    q/k_new/v_new (H, D); ck/cv (W, H, D) not yet holding this token.
    """
    window = ck.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("hd,whd->hw", q.float(), ck.float()) * scale
    slots = torch.arange(window, device=q.device)
    valid = (pos - torch.remainder(pos - slots, window) >= 0) & (slots != pos % window)
    logits = logits.masked_fill(~valid[None, :], float("-inf"))
    self_score = (q.float() * k_new.float()).sum(dim=-1, keepdim=True) * scale
    probs = torch.softmax(torch.cat([logits, self_score], dim=-1), dim=-1)
    out = torch.einsum("hw,whd->hd", probs[:, :window].to(q.dtype).float(), cv.float())
    out = out + probs[:, window:] * v_new.float()
    return out.to(q.dtype)


class RingCache:
    """Per-layer (W, H, D) key/value rings for one sequence."""

    def __init__(self, n_layers: int, window: int, n_heads: int, head_dim: int,
                 dtype, device):
        self.window = window
        self.k = torch.zeros((n_layers, window, n_heads, head_dim), dtype=dtype,
                             device=device)
        self.v = torch.zeros_like(self.k)


@torch.no_grad()
def decode_step(model: CodecLM, token: int, pos: int, cache: RingCache):
    """Feed ``token`` at position ``pos`` through every layer; returns f32
    logits (1, V) and writes the token's k/v into slot ``pos % window``."""
    cfg = model.cfg
    dev = cache.k.device
    x = model.embed.weight[token][None, None]                  # (1, 1, dim)
    cos, sin = rope_angles(torch.tensor([pos], device=dev), cfg.head_dim)
    slot = pos % cache.window
    for li, layer in enumerate(model.ar.layers):
        q, k, v = layer.qkv(x, cos, sin)
        attn = decode_attention(q[0, 0], cache.k[li], cache.v[li], pos, k[0, 0], v[0, 0])
        cache.k[li, slot] = k[0, 0]
        cache.v[li, slot] = v[0, 0]
        x = layer.finish(x, attn[None, None])
    logits = linear(model.ar.norm(x), model.ar.output.weight)[:, 0]
    return logits.float()


def uniform_stream(uniforms, generator, seed: int, n: int, device):
    """The AR's uniforms: the given ones (flattened), or ``n`` drawn on
    ``device`` from ``generator`` (or one seeded with ``seed``)."""
    if uniforms is not None:
        return torch.as_tensor(np.asarray(uniforms, np.float32).reshape(-1), device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n,), generator=generator, device=device)


def prefill_prompt(model: CodecLM, prompt, spk_codes, window: int):
    """Prefill over ``prompt`` (1-D ids) with the speaker vector of
    ``spk_codes`` (S, 8): (all logits incl. the speaker row, per-layer (k, v))."""
    if len(prompt) + 1 > window:
        raise ValueError(f"prompt {len(prompt)}+1 exceeds cache window {window}")
    dev = model.embed.weight.device
    spk = torch.as_tensor(np.asarray(spk_codes, np.int64), device=dev)[None]
    tok = torch.as_tensor(prompt, device=dev)[None]
    return model.prefill(tok, model.spk_embedding(spk))


def sample_tokens(logits, prompt, s: ArSampling, uniforms, step):
    """The decode loop shared by the AR engines: sample from ``logits`` (1, V)
    with the k-th generated token consuming ``uniforms[k]``, then
    ``step(token, position)`` gives the next logits. Returns (sequence incl.
    the prompt and without the closing EOS, n_generated)."""
    tokens = list(prompt.tolist())
    counts = torch.zeros((1, logits.shape[-1]), dtype=torch.int32, device=logits.device)
    n_gen = 0
    while True:
        logprobs = filter_logits(logits, s, counts, n_gen)
        t = int(sample_from_logprobs(logprobs, uniforms[min(n_gen, s.max_len - 1)][None])[0])
        if t == s.eos_idx or len(tokens) >= s.max_len:
            break
        tokens.append(t)
        n_gen += 1
        counts[0, t] += 1
        if n_gen > s.penalty_window and len(tokens) - 1 - s.penalty_window >= 0:
            counts[0, tokens[len(tokens) - 1 - s.penalty_window]] -= 1
        if len(tokens) >= s.max_len:
            break
        logits = step(t, len(tokens))
    return np.asarray(tokens, np.int64), n_gen


@torch.no_grad()
def ar_generate(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                uniforms=None, generator: torch.Generator | None = None,
                seed: int = 0):
    """Complete one ``prompt`` (1-D token ids) conditioned on ``spk_codes``
    (S, 8). Returns (np.ndarray sequence incl. the prompt and without the
    closing EOS, n_generated).

    The k-th generated token consumes ``uniforms[k]``; without ``uniforms`` the
    stream is drawn on the model's device from ``generator`` (or one seeded
    with ``seed``).
    """
    s = sampling
    cfg = model.cfg
    dev = model.embed.weight.device
    prompt = np.asarray(prompt, np.int64)
    window = min(cfg.sliding_window, s.max_len + 1)
    all_logits, kvs = prefill_prompt(model, prompt, spk_codes, window)
    uniforms = uniform_stream(uniforms, generator, seed, s.max_len, dev)
    cache = RingCache(cfg.n_layers, window, cfg.n_kv_heads, cfg.head_dim,
                      kvs[0][0].dtype, dev)
    for li, (k, v) in enumerate(kvs):
        cache.k[li, : k.shape[1]] = k[0]
        cache.v[li, : v.shape[1]] = v[0]
    return sample_tokens(all_logits[:, len(prompt)].float(), prompt, s, uniforms,
                         lambda t, pos: decode_step(model, t, pos, cache))
