"""KV-cached AR generation over one or more rows, and the resumable per-row
decode state a serving pool runs on (counterpart of
``mars5_tts_tpu/models/ar_decode.py``).

Prefill over each row's prompt, then one token a row per step through
a ring cache of ``window = min(sliding_window, max_len + 1)`` slots written
at ``position % window``. For a row at position p, slot s holds position
``p - ((p - s) mod window)``; negative positions (never written, or prompt
padding ahead of the cursor) and the current token's own stale slot are
masked, and the current token attends to itself through an explicit extra
column: kernel K7 (``ops/kernels/decode_attention``) on the card, its plain
twin on the CPU. Position 0 is the speaker vector; token i sits at position
i + 1.

Each row carries its own tokens, cursor, generated count, penalty counts,
early-EOS length estimate, done flag, uniform stream and ring (the JAX
``DecodeState``), and its own sampling values (``RowSampling``). The state
is resumable: ``prefill_row`` builds a row with its first token sampled,
``decode_chunk`` runs at most n steps of every row, ``extract_row`` /
``insert_row`` move a row between states and ``make_parked_state`` is a
pool of free (done) rows. A done row appends nothing and stops counting;
like the JAX engine, every decode step runs all rows (a done or parked row
at its frozen position); rows never read each other, so a row's tokens are
those of its solo run. ``ar_generate``, ``ar_generate_batched``, the
quantized engine and the serving pools all run one loop,
``decode_loop``.

``ar_generate_nocache`` is the reference's ``use_kv_cache=False``: every
step runs the full prefill over the token buffer and samples at each row's
cursor.

Randomness is an explicit (max_len, rows) stream of uniforms, row i's k-th
generated token consuming ``uniforms[k, i]``, or one drawn from a seeded
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.kernels.decode_attention import decode_attention
from ..ops.quant import linear_any
from ..ops.rope import rope_angles
from ..ops.sampling import (apply_typical_p, early_eos_penalty, filter_topk_subset_rows,
                            freq_presence_penalty, mask_vocab_window, sample_from_logprobs,
                            top_k_top_p_filter)
from ..utils.device import ints_on_device
from .ar import CodecLM, CodecLMConfig


def ar_vocab_window(n_text_vocab: int, n_speech_vocab: int,
                    n_model_vocab: int) -> tuple[int, int]:
    """(valid_start, valid_end) of the speech-token window, the end clamped to
    the model's vocabulary so ids past ``text + speech`` are never sampled."""
    return n_text_vocab, min(n_text_vocab + n_speech_vocab, n_model_vocab)


@dataclass(frozen=True)
class ArSampling:
    """Sampling hyperparameters for one generation. A pool takes its vocab
    window, EOS id, ``max_len`` and top-k extraction width (``top_k``) from
    here; the rest are each row's defaults (``rows_from_sampling``)."""

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


ROW_FIELDS = ("temperature", "top_k", "top_p", "typical_p", "alpha_frequency",
              "alpha_presence", "penalty_window", "eos_penalty_decay", "eos_penalty_factor")


@dataclass
class RowSampling:
    """Per-row sampling values of B rows, each a (B,) host array (the JAX
    ``RowSampling``): a row's top_k is at most the pool's extraction width
    (``ArSampling.top_k``); top_p >= 1 and typical_p > 0.999 leave those
    filters off for the row. The values the logit pipeline reads on the
    device are copied there once per device (``on``)."""

    temperature: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    typical_p: np.ndarray
    alpha_frequency: np.ndarray
    alpha_presence: np.ndarray
    penalty_window: np.ndarray
    eos_penalty_decay: np.ndarray
    eos_penalty_factor: np.ndarray
    _device: dict = field(default_factory=dict, repr=False, compare=False)

    def on(self, device) -> dict:
        """The device values: temperature, alpha_frequency, alpha_presence
        (B, 1) f32, top_k (B,) int64, top_p, typical_p (B,) f32."""
        device = torch.device(device)
        if device not in self._device:
            def f32(a):
                return torch.tensor(np.asarray(a, np.float32), device=device)
            self._device[device] = {
                "temperature": f32(self.temperature)[:, None],
                "alpha_frequency": f32(self.alpha_frequency)[:, None],
                "alpha_presence": f32(self.alpha_presence)[:, None],
                "top_k": torch.tensor(np.asarray(self.top_k, np.int64), device=device),
                "top_p": f32(self.top_p), "typical_p": f32(self.typical_p)}
        return self._device[device]


def rows_from_sampling(s: ArSampling, bs: int, overrides: dict | None = None,
                       cap_top_k: int | None = None) -> RowSampling:
    """``s`` broadcast to ``bs`` rows, with ``overrides`` (name -> value) in
    place of its values; top_k clamped to ``cap_top_k`` (default ``s.top_k``),
    the pool's extraction width."""
    o = overrides or {}
    vals = {n: np.full(bs, o.get(n, getattr(s, n)),
                       np.int64 if n in ("top_k", "penalty_window") else np.float64)
            for n in ROW_FIELDS}
    vals["top_k"] = np.minimum(vals["top_k"], s.top_k if cap_top_k is None else cap_top_k)
    return RowSampling(**vals)


def insert_rows_sampling(pool: RowSampling, row: RowSampling, b: int) -> RowSampling:
    """A new pool RowSampling with slot ``b`` set to the one-row ``row``."""
    vals = {}
    for n in ROW_FIELDS:
        v = getattr(pool, n).copy()
        v[b] = getattr(row, n)[0]
        vals[n] = v
    return RowSampling(**vals)


def filter_logits(logits, s: ArSampling, counts, n_gen, est_len, rows: RowSampling):
    """The per-step logit pipeline over rows, each with its own ``rows``
    values: penalties (rows past their second generated token), vocab
    window, early-EOS, temperature, top-k/top-p/typical-p, window again,
    log-softmax. logits (B, V) f32; counts (B, V); n_gen and est_len (B,)
    host arrays."""
    dv = rows.on(logits.device)
    penalize = np.asarray(n_gen) > 1
    if penalize.any():
        pen = freq_presence_penalty(logits, counts, dv["alpha_frequency"],
                                    dv["alpha_presence"])
        logits = pen if penalize.all() else torch.where(
            ints_on_device(penalize, logits.device, torch.bool)[:, None], pen, logits)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    logits = early_eos_penalty(logits, n_gen, est_len, rows.eos_penalty_decay,
                               rows.eos_penalty_factor, s.eos_idx)
    logits = logits / dv["temperature"]
    if s.top_k > 0:
        # a block no row needs is skipped (the host values say which)
        logits = filter_topk_subset_rows(
            logits, s.top_k, dv["top_k"] if (rows.top_k < s.top_k).any() else None,
            dv["top_p"] if (rows.top_p < 1.0).any() else None,
            dv["typical_p"] if (rows.typical_p <= 0.999).any() else None)
    else:
        # the full-vocabulary filters take one top_p and typical_p for all rows
        if len(set(rows.top_p.tolist())) > 1 or len(set(rows.typical_p.tolist())) > 1:
            raise ValueError("per-row top_p / typical_p need a top-k extraction width "
                             "(ArSampling.top_k > 0)")
        logits = apply_typical_p(top_k_top_p_filter(logits, 0, float(rows.top_p[0])),
                                 float(rows.typical_p[0]))
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

    def write_prompt(self, row: int, kv) -> None:
        """A prefill's per-layer (k, v), each (1, P + 1, H, D), into slots
        [0, P + 1) of ``row``."""
        for li, (k, v) in enumerate(kv):
            self.k[li, row, : k.shape[1]] = k[0]
            self.v[li, row, : v.shape[1]] = v[0]

    def take_row(self, j: int) -> "RingCache":
        """A one-row copy of row ``j``."""
        out = RingCache.__new__(RingCache)
        out.window = self.window
        out.k, out.v = self.k[:, j:j + 1].clone(), self.v[:, j:j + 1].clone()
        return out

    def put_row(self, b: int, row: "RingCache") -> None:
        """Overwrite row ``b``'s rings whole with the one-row ``row``'s."""
        self.k[:, b] = row.k[:, 0]
        self.v[:, b] = row.v[:, 0]


@dataclass
class DecodeState:
    """The resumable decode state of B rows (the JAX ``DecodeState``):
    tokens (B, max_len) (prompt then generated), cursor, generated count,
    early-EOS estimate and done flag, each (B,), on the host; penalty counts
    (B, V) int32 and the uniforms (max_len, B) f32 on the device; the
    rows' cache (``RingCache``, or the quantized engine's ``FusedCache``);
    and ``steps``, the decode steps run on it so far."""

    tokens: np.ndarray
    cur: np.ndarray
    n_gen: np.ndarray
    est_len: np.ndarray
    done: np.ndarray
    counts: torch.Tensor
    uniforms: torch.Tensor
    cache: object
    steps: int = 0

    @property
    def batch(self) -> int:
        return len(self.cur)

    def results(self) -> list:
        """One (sequence incl. the prompt and without the closing EOS,
        n_generated) per row."""
        return [(self.tokens[i, : self.cur[i]].copy(), int(self.n_gen[i]))
                for i in range(self.batch)]


def sample_update(state: DecodeState, logits, s: ArSampling, rows: RowSampling) -> None:
    """Sample one token a row from ``logits`` (B, V), row i's k-th generated
    token consuming ``uniforms[min(k, max_len - 1), i]``, and advance each
    live row's state in place (the JAX ``_sample_and_update``)."""
    st = state
    b = st.batch
    idx = np.arange(b)
    logprobs = filter_logits(logits, s, st.counts, st.n_gen, st.est_len, rows)
    k = np.minimum(st.n_gen, s.max_len - 1)
    u = torch.stack([st.uniforms[int(k[i]), i] for i in range(b)])
    tok = sample_from_logprobs(logprobs, u).cpu().numpy()
    active = ~st.done
    appends = active & (tok != s.eos_idx) & (st.cur < s.max_len)
    at = np.minimum(st.cur, s.max_len - 1)
    st.tokens[idx, at] = np.where(appends, tok, st.tokens[idx, at])
    pw = rows.penalty_window
    evict_pos = st.cur - pw                     # the token leaving the window
    evict = appends & (st.n_gen + 1 > pw) & (evict_pos >= 0)
    evict_tok = st.tokens[idx, np.clip(evict_pos, 0, s.max_len - 1)]
    # host ints index the counts, one small op a row: an index tensor would
    # cost a host-to-device copy a step
    for i in np.flatnonzero(appends):
        st.counts[int(i), int(tok[i])] += 1
    for i in np.flatnonzero(evict):
        st.counts[int(i), int(evict_tok[i])] -= 1
    st.cur = st.cur + appends
    st.n_gen = st.n_gen + appends
    st.done = st.done | (active & (tok == s.eos_idx)) | (st.cur >= s.max_len)


def decode_loop(state: DecodeState, s: ArSampling, rows: RowSampling, step,
                n_steps: int | None = None) -> DecodeState:
    """Decode steps until every row is done, or at most ``n_steps``: each
    step ``step(tokens (B,), positions (B,))`` feeds every row's last token
    at its cursor through the model (writing its K/V into ``state.cache``)
    and returns the next (B, V) f32 logits, which ``sample_update`` samples.
    Returns ``state``, advanced in place."""
    idx = np.arange(state.batch)
    i = 0
    while not state.done.all() and (n_steps is None or i < n_steps):
        logits = step(state.tokens[idx, np.maximum(state.cur - 1, 0)], state.cur)
        sample_update(state, logits, s, rows)
        i += 1
    state.steps += i
    return state


def sample_rows(state: DecodeState, s: ArSampling, rows: RowSampling, step) -> list:
    """Run ``state`` to completion (``decode_loop``); returns one (sequence
    incl. the prompt and without the closing EOS, n_generated) per row."""
    return decode_loop(state, s, rows, step).results()


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
    logits = linear_any(model.ar.norm(x), model.ar.output.weight)[:, 0]
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


def new_state(prompts, s: ArSampling, n_vocab: int, uniforms, cache,
              est_lens=None) -> DecodeState:
    """A state of ``prompts`` (1-D ids) before its first sample: cursors at
    the prompt ends, counts zero, no row done; ``uniforms`` (max_len, B) on
    the device, ``est_lens`` (B,) (default ``s.n_phones_gen``)."""
    b = len(prompts)
    tokens = np.zeros((b, s.max_len), np.int64)
    cur = np.zeros(b, np.int64)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
        cur[i] = len(p)
    est = (np.full(b, s.n_phones_gen, np.int64) if est_lens is None
           else np.asarray(est_lens, np.int64).copy())
    return DecodeState(tokens=tokens, cur=cur, n_gen=np.zeros(b, np.int64), est_len=est,
                       done=np.zeros(b, bool),
                       counts=torch.zeros((b, n_vocab), dtype=torch.int32,
                                          device=uniforms.device),
                       uniforms=uniforms, cache=cache)


@torch.no_grad()
def prefill_state(model: CodecLM, s: ArSampling, prompts, spk_codes_list, uniforms,
                  est_lens=None, rows: RowSampling | None = None) -> DecodeState:
    """Prefill ``prompts`` (each row at its own length, ``prefill_rows``)
    into a bf16 ring of B rows and sample each row's first token: a
    ready-to-decode state. ``uniforms`` (max_len, B) on the model's device;
    ``rows`` default ``rows_from_sampling(s, B)``."""
    cfg = model.cfg
    prompts = [np.asarray(p, np.int64) for p in prompts]
    window = min(cfg.sliding_window, s.max_len + 1)
    logits, kvs = prefill_rows(model, prompts, spk_codes_list, window)
    cache = RingCache(cfg.n_layers, len(prompts), window, cfg.n_kv_heads, cfg.head_dim,
                      kvs[0][0][0].dtype, logits.device)
    for r, kv in enumerate(kvs):
        cache.write_prompt(r, kv)
    state = new_state(prompts, s, cfg.n_vocab, uniforms, cache, est_lens)
    sample_update(state, logits, s, rows or rows_from_sampling(s, len(prompts)))
    return state


def prefill_row(model: CodecLM, s: ArSampling, prompt, spk_codes, uniforms, est_len=None,
                rows: RowSampling | None = None) -> DecodeState:
    """One request's prefill for a serving pool: a one-row state with its
    first token sampled (``insert_row`` puts it into a pool). ``uniforms``
    (max_len,) or (max_len, 1) on the model's device; ``rows`` (one row)
    carries the request's own sampling values."""
    return prefill_state(model, s, [prompt], [spk_codes], uniforms.reshape(-1, 1),
                         None if est_len is None else [est_len], rows)


@torch.no_grad()
def decode_chunk(model: CodecLM, s: ArSampling, state: DecodeState, n_steps: int,
                 rows: RowSampling | None = None) -> DecodeState:
    """At most ``n_steps`` decode steps of every row of ``state`` (fewer when
    every row is done): a serving pool's scheduling quantum. Rows decode
    independently, so chunked decoding gives each row the tokens of one
    uninterrupted run."""
    return decode_loop(state, s, rows or rows_from_sampling(s, state.batch),
                       lambda t, pos: decode_step(model, t, pos, state.cache), n_steps)


def extract_row(state: DecodeState, j: int) -> DecodeState:
    """Row ``j`` of ``state`` as a one-row state (copies)."""
    return DecodeState(tokens=state.tokens[j:j + 1].copy(), cur=state.cur[j:j + 1].copy(),
                       n_gen=state.n_gen[j:j + 1].copy(),
                       est_len=state.est_len[j:j + 1].copy(),
                       done=state.done[j:j + 1].copy(), counts=state.counts[j:j + 1].clone(),
                       uniforms=state.uniforms[:, j:j + 1].clone(),
                       cache=state.cache.take_row(j))


def insert_row(state: DecodeState, row: DecodeState, b: int) -> DecodeState:
    """Write the one-row ``row`` into slot ``b`` of ``state``, in place: every
    field, the slot's rings whole. Returns ``state``."""
    for name in ("tokens", "cur", "n_gen", "est_len", "done"):
        getattr(state, name)[b] = getattr(row, name)[0]
    state.counts[b] = row.counts[0]
    state.uniforms[:, b] = row.uniforms[:, 0]
    state.cache.put_row(b, row.cache)
    return state


def parked_fields(s: ArSampling, bs: int, n_vocab: int, device) -> dict:
    """Every field of a state of ``bs`` free rows but its cache: done, at
    cursor 0, zero tokens, counts and uniforms."""
    return dict(tokens=np.zeros((bs, s.max_len), np.int64), cur=np.zeros(bs, np.int64),
                n_gen=np.zeros(bs, np.int64), est_len=np.zeros(bs, np.int64),
                done=np.ones(bs, bool),
                counts=torch.zeros((bs, n_vocab), dtype=torch.int32, device=device),
                uniforms=torch.zeros((s.max_len, bs), dtype=torch.float32, device=device))


def make_parked_state(cfg: CodecLMConfig, s: ArSampling, bs: int, dtype, device) -> DecodeState:
    """A state of ``bs`` free rows (all done) for a serving pool: a parked
    row keeps decoding at its frozen position and appends nothing."""
    window = min(cfg.sliding_window, s.max_len + 1)
    return DecodeState(**parked_fields(s, bs, cfg.n_vocab, device),
                       cache=RingCache(cfg.n_layers, bs, window, cfg.n_kv_heads, cfg.head_dim,
                                       dtype, device))


@torch.no_grad()
def ar_generate_batched(model: CodecLM, prompts, spk_codes_list, *, sampling: ArSampling,
                        uniforms=None, generator: torch.Generator | None = None,
                        seed: int = 0, est_lens=None, rows: RowSampling | None = None):
    """Complete each of ``prompts`` (1-D token ids) conditioned on its
    ``spk_codes_list`` entry (S_i, 8). Returns one (np.ndarray sequence incl.
    the prompt and without the closing EOS, n_generated) per row.

    ``uniforms`` (max_len, B): row i's k-th generated token consumes
    ``uniforms[k, i]``; without it the stream is drawn on the model's device
    from ``generator`` (or one seeded with ``seed``). ``est_lens`` (B,): each
    row's early-EOS length estimate (default ``sampling.n_phones_gen``);
    ``rows``: each row's sampling values (default ``sampling``'s).
    Each row's prompt fills the first ``P_i + 1`` slots of its ring; the
    slots past them stay masked (their position is negative) until the row's
    own tokens overwrite them.
    """
    s = sampling
    dev = model.embed.weight.device
    rows = rows or rows_from_sampling(s, len(prompts))
    u = uniform_stream(uniforms, generator, seed, s.max_len, len(prompts), dev)
    state = prefill_state(model, s, prompts, spk_codes_list, u, est_lens, rows)
    return sample_rows(state, s, rows, lambda t, pos: decode_step(model, t, pos, state.cache))


def ar_generate(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                uniforms=None, generator: torch.Generator | None = None, seed: int = 0):
    """Complete one ``prompt`` (1-D token ids) conditioned on ``spk_codes``
    (S, 8): ``ar_generate_batched`` with one row, the k-th generated token
    consuming ``uniforms[k]``. Returns (np.ndarray sequence incl. the prompt
    and without the closing EOS, n_generated)."""
    return ar_generate_batched(model, [prompt], [spk_codes], sampling=sampling,
                               uniforms=uniforms, generator=generator, seed=seed)[0]


@torch.no_grad()
def ar_generate_nocache(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                        uniforms=None, generator: torch.Generator | None = None,
                        seed: int = 0):
    """``ar_generate`` without a cache (the reference's ``use_kv_cache=False``):
    every step runs the full prefill over the (1, max_len) token buffer (the
    banded sliding-window mask; causality leaves the cursor's logits to the
    tokens before it) and samples at the cursor. The same API and uniform
    stream as ``ar_generate``."""
    s = sampling
    dev = model.embed.weight.device
    u = uniform_stream(uniforms, generator, seed, s.max_len, 1, dev)
    spk = torch.as_tensor(np.asarray(spk_codes, np.int64), device=dev)[None]
    spk_vec = model.spk_embedding(spk)
    state = new_state([np.asarray(prompt, np.int64)], s, model.cfg.n_vocab, u, None)
    rows = rows_from_sampling(s, 1)

    def logits_at_cursor():
        buf = torch.as_tensor(state.tokens, device=dev)
        all_logits, _ = model.prefill(buf, spk_vec)
        return all_logits[:, int(state.cur[0])].float()

    sample_update(state, logits_at_cursor(), s, rows)
    return sample_rows(state, s, rows, lambda t, pos: logits_at_cursor())[0]
