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
those of its solo run.

The decode engine is chosen once, as an object, and every entry point here
takes it: ``ModelEngine``, the model as loaded (``engine=None``), or the
quantized engine of ``models/ar_decode_fused`` (``FusedEngine``). An engine
answers which cache B rows hold, which step route runs it, and how many
rows and which window it takes; the one loop, ``decode_loop``, runs the
route (``Route``) it gives. The sampler works on the device alone: each
state keeps the fields a step reads on the device too (``DeviceState``),
the logit pipeline, the draw and the bookkeeping update them there, and the
host's fields follow from one readback of the drawn tokens a step. On the
card the quantized engine's step (``FusedStep``) and the latent-attention
step (``LatentStep``) replay one CUDA graph a step (``models/ar_graphs``);
the bf16 ring's step (``RingStep``) runs the same sampler eagerly. A route
whose step reads its input from the device state (``Route.pipelined``: the
quantized and the latent steps) runs one step ahead: the loop launches step
i + 1 before it waits for step i's tokens, so the card has the next step
queued while the host reads back and prepares it.

A DeepSeek-V2 backbone (``cfg.attention == "mla"``) keeps a ``LatentCache``
in place of the ring of keys and values: each position's normed latent and
its roped shared key, with the same row operations. Its decode step runs
latent attention in the absorbed form over the ring's slots
(``MLAttention.absorbed``) and its experts through kernel K10, which reads
the routing on the device; the routed slots are tallied per layer and
expert on the device (``expert_load``), with no sync.

``ar_generate_nocache`` is the reference's ``use_kv_cache=False``: every
step (``NoCacheStep``) runs the full prefill over the token buffer and
samples at the row's cursor.

Randomness is an explicit (max_len, rows) stream of uniforms, row i's k-th
generated token consuming ``uniforms[k, i]``, or one drawn from a seeded
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels.decode_attention import decode_attention, ring_valid
from ..ops.sampling import (apply_typical_p, early_eos_table, filter_topk_subset_rows,
                            freq_presence_penalty, mask_vocab_window, sample_from_logprobs,
                            top_k_top_p_filter)
from ..utils.device import ints_on_device
from ..utils.profiling import span
from . import ar_graphs
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
    filters off for the row. A state's ``DeviceState`` holds the values the
    logit pipeline reads."""

    temperature: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    typical_p: np.ndarray
    alpha_frequency: np.ndarray
    alpha_presence: np.ndarray
    penalty_window: np.ndarray
    eos_penalty_decay: np.ndarray
    eos_penalty_factor: np.ndarray


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


def filter_blocks(s: ArSampling, rows: RowSampling) -> tuple:
    """What of the top-k stage ``filter_logits`` runs, from the host values:
    with an extraction width (``s.top_k > 0``) whether some row needs its
    own top-k, top-p, typical-p block (a block no row needs is skipped);
    without one, the top_p and typical mass every row shares. Fixed for a
    call or a pool's rows, and part of a decode graph's key."""
    if s.top_k > 0:
        return (bool((rows.top_k < s.top_k).any()), bool((rows.top_p < 1.0).any()),
                bool((rows.typical_p <= 0.999).any()))
    # the full-vocabulary filters take one top_p and typical_p for all rows
    if len(set(rows.top_p.tolist())) > 1 or len(set(rows.typical_p.tolist())) > 1:
        raise ValueError("per-row top_p / typical_p need a top-k extraction width "
                         "(ArSampling.top_k > 0)")
    return float(rows.top_p[0]), float(rows.typical_p[0])


def filter_logits(logits, s: ArSampling, counts, dev: "DeviceState", blocks: tuple):
    """The per-step logit pipeline over rows, each with its own sampling
    values, on the device alone: penalties (rows past their second
    generated token), vocab window, early-EOS (each row's modifier at its
    generated count), temperature, top-k/top-p/typical-p (``blocks``, from
    ``filter_blocks``), window again, log-softmax. logits (B, V) f32;
    counts (B, V); ``dev`` the state's ``DeviceState``."""
    pen = freq_presence_penalty(logits, counts, dev.alpha_frequency, dev.alpha_presence)
    logits = torch.where((dev.n_gen > 1)[:, None], pen, logits)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    logits[:, s.eos_idx].sub_(dev.eos_modifier[dev.rows, dev.n_gen])
    logits = logits / dev.temperature
    if s.top_k > 0:
        k_on, p_on, typical_on = blocks
        logits = filter_topk_subset_rows(logits, s.top_k, dev.top_k if k_on else None,
                                         dev.top_p if p_on else None,
                                         dev.typical_p if typical_on else None)
    else:
        top_p, typical = blocks
        logits = apply_typical_p(top_k_top_p_filter(logits, 0, top_p), typical)
    logits = mask_vocab_window(logits, s.valid_start, s.valid_end)
    return torch.log_softmax(logits, dim=-1)


class RingCache:
    """Per-layer (B, W, H, D) key/value rings of B rows: (L, B, W, H, D);
    H is a tensor-parallel rank's own heads."""

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


class LatentCache:
    """Latent attention's per-layer rings of B rows: each position's normed
    latent and roped shared key side by side, (L, B, W, R + rope) in
    ``ckv``, with ``RingCache``'s row operations (``write_prompt`` takes a
    prefill's per-layer (c, k_pe)). On the card the decode loop replays its
    steps as CUDA graphs (``LatentStep``)."""

    def __init__(self, n_layers: int, batch: int, window: int, rank: int, rope_dim: int,
                 dtype, device):
        self.window, self.rank = window, rank
        self.ckv = torch.zeros((n_layers, batch, window, rank + rope_dim), dtype=dtype,
                               device=device)

    def write_prompt(self, row: int, states) -> None:
        """A prefill's per-layer (c, k_pe), each (1, P + 1, .), into slots
        [0, P + 1) of ``row``."""
        for li, (c, k_pe) in enumerate(states):
            self.ckv[li, row, : c.shape[1]] = torch.cat([c[0], k_pe[0]], dim=-1)

    def take_row(self, j: int) -> "LatentCache":
        """A one-row copy of row ``j``."""
        out = LatentCache.__new__(LatentCache)
        out.window, out.rank = self.window, self.rank
        out.ckv = self.ckv[:, j:j + 1].clone()
        return out

    def put_row(self, b: int, row: "LatentCache") -> None:
        """Overwrite row ``b``'s rings whole with the one-row ``row``'s, in
        place (a graph made on this cache stays valid)."""
        self.ckv[:, b] = row.ckv[:, 0]


def make_cache(cfg: CodecLMConfig, batch: int, window: int, dtype, device,
               n_heads: int | None = None) -> RingCache:
    """The empty rings of ``cfg``'s block for ``batch`` rows: a ``LatentCache``
    for latent attention, else a ``RingCache`` of ``n_heads`` heads (default
    ``cfg.n_kv_heads``; a tensor-parallel rank's own)."""
    if cfg.attention == "mla":
        return LatentCache(cfg.n_layers, batch, window, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                           dtype, device)
    return RingCache(cfg.n_layers, batch, window, n_heads or cfg.n_kv_heads, cfg.head_dim,
                     dtype, device)


def expert_load(model: CodecLM):
    """The model's (n_layers, E) int32 tally of routed decode slots on its
    device, made at first use (None for a model without experts): K10 adds
    one a slot, so no step waits for it; zero it before a call and read it
    after (``expert_load_summary``)."""
    cfg = model.cfg
    if not cfg.n_routed_experts:
        return None
    if model.expert_load is None:
        model.expert_load = torch.zeros((cfg.n_layers, cfg.n_routed_experts), dtype=torch.int32,
                                        device=model.embed.weight.device)
    return model.expert_load


def expert_load_summary(model: CodecLM):
    """{"max", "mean"}: each expert layer's largest and mean tally of routed
    decode slots (one read of the tally), or None without experts."""
    load = expert_load(model)
    if load is None:
        return None
    t = load[model.cfg.first_k_dense:].cpu().double()
    return {"max": t.max(dim=1).values.tolist(), "mean": t.mean(dim=1).tolist()}


class DeviceState:
    """A ``DecodeState``'s fields on the device, which a decode step reads
    and writes with no host work: each row's last token, cursor, generated
    count, penalty window and top-k (``ints``, (5, B) int64), temperature
    and penalty weights ((B, 1) f32), top-p and typical mass (``floats``),
    done flag, token history (B, max_len) int64, early-EOS modifier at each
    generated count (B, max_len + 1) f32, 0 past the row's estimate
    (``early_eos_table``), and ``out`` (B, 2) int64, the step's one
    readback: each row's drawn token and whether it had no finite logprob.
    ``load`` writes them from the host's fields in place, so a graph made on
    them stays valid; ``buffer`` keeps a route's static tensors. ``post``
    queues a copy of ``out`` into one of two host buffers (pinned on the
    card, made with the state: the pinned pool does not grow in the loop)
    and ``fetch`` waits for it, so a step's tokens can be read while the
    next step runs."""

    INTS = ("tok", "cur", "n_gen", "penalty_window", "top_k")
    FLOATS = ("temperature", "alpha_frequency", "alpha_presence", "top_p", "typical_p")

    def __init__(self, batch: int, max_len: int, device):
        self.ints = torch.zeros((len(self.INTS), batch), dtype=torch.int64, device=device)
        self.floats = torch.zeros((len(self.FLOATS), batch), dtype=torch.float32,
                                  device=device)
        for name, row in zip(self.INTS, self.ints):
            setattr(self, name, row)
        for name, row in zip(self.FLOATS, self.floats):
            setattr(self, name, row if name in ("top_p", "typical_p") else row[:, None])
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.hist = torch.zeros((batch, max_len), dtype=torch.int64, device=device)
        self.eos_modifier = torch.zeros((batch, max_len + 1), dtype=torch.float32, device=device)
        self.out = torch.zeros((batch, 2), dtype=torch.int64, device=device)
        pinned = self.out.is_cuda
        self.host = torch.zeros((2, batch, 2), dtype=torch.int64, pin_memory=pinned)
        self.copied = [torch.cuda.Event() for _ in range(2)] if pinned else None
        self.rows = torch.arange(batch, device=device)
        self._buffers = {}

    def load(self, st: "DecodeState", rows: RowSampling) -> None:
        """Every field from ``st``'s host fields and the rows' sampling
        values: a few host-to-device copies and the early-EOS table on the
        host, once a decode loop."""
        last = st.tokens[np.arange(st.batch), np.maximum(st.cur - 1, 0)]
        ints = np.stack([last, st.cur, st.n_gen, rows.penalty_window, rows.top_k])
        self.ints.copy_(torch.from_numpy(ints.astype(np.int64)))
        self.floats.copy_(torch.from_numpy(np.stack([np.asarray(getattr(rows, n), np.float32)
                                                     for n in self.FLOATS])))
        self.done.copy_(torch.from_numpy(np.asarray(st.done, bool)))
        self.hist.copy_(torch.from_numpy(np.asarray(st.tokens, np.int64)))
        n = self.eos_modifier.shape[1] - 1
        self.eos_modifier.copy_(torch.stack([
            early_eos_table(int(e), float(d), float(f), n)
            for e, d, f in zip(st.est_len, rows.eos_penalty_decay, rows.eos_penalty_factor)]))

    def post(self, k: int) -> None:
        """Queue the copy of ``out`` into host buffer ``k`` (0 or 1) behind
        the work that wrote it, without waiting. The copy runs on the
        current stream of ``out``'s card, which need not be the current
        card, and the event is recorded there."""
        self.host[k].copy_(self.out, non_blocking=True)
        if self.copied is not None:
            self.copied[k].record(torch.cuda.current_stream(self.out.device))

    def fetch(self, k: int) -> np.ndarray:
        """Host buffer ``k`` once its copy has landed (the host waits here)."""
        if self.copied is not None:
            self.copied[k].synchronize()
        return self.host[k].numpy()

    def buffer(self, name: str, shape: tuple, dtype) -> torch.Tensor:
        """The static tensor ``name`` of a route (zeros at first use)."""
        t = self._buffers.get(name)
        if t is None:
            t = self._buffers[name] = torch.zeros(shape, dtype=dtype, device=self.rows.device)
        return t


@dataclass
class DecodeState:
    """The resumable decode state of B rows (the JAX ``DecodeState``):
    tokens (B, max_len) (prompt then generated), cursor, generated count,
    early-EOS estimate and done flag, each (B,), on the host; penalty counts
    (B, V) int32 and the uniforms (max_len, B) f32 on the device; the
    rows' cache (``RingCache``, ``LatentCache``, or the quantized engine's
    ``FusedCache``); ``steps``, the decode steps run on it so far; ``dev``,
    the fields a step reads on the device (``DeviceState``, made at the
    first draw and loaded from the host fields at each decode loop); and
    ``graphs``, its decode steps' CUDA graphs (``models/ar_graphs``). The
    host fields mirror the device's: each step's readback updates them by
    the same rules, so code between loops reads and writes them (a pool's
    inserts) and the next loop loads them."""

    tokens: np.ndarray
    cur: np.ndarray
    n_gen: np.ndarray
    est_len: np.ndarray
    done: np.ndarray
    counts: torch.Tensor
    uniforms: torch.Tensor
    cache: object
    steps: int = 0
    dev: DeviceState | None = None
    graphs: object = None

    @property
    def batch(self) -> int:
        return len(self.cur)

    def results(self) -> list:
        """One (sequence incl. the prompt and without the closing EOS,
        n_generated) per row."""
        return [(self.tokens[i, : self.cur[i]].copy(), int(self.n_gen[i]))
                for i in range(self.batch)]


def load_device_state(state: DecodeState, s: ArSampling, rows: RowSampling) -> tuple:
    """Loads ``state.dev`` (made at first use) from the host fields and
    ``rows``; returns the rows' ``filter_blocks``."""
    blocks = filter_blocks(s, rows)
    if state.dev is None:
        state.dev = DeviceState(state.batch, state.tokens.shape[1], state.counts.device)
    state.dev.load(state, rows)
    return blocks


def draw(state: DecodeState, logits, s: ArSampling, blocks: tuple) -> None:
    """Sample one token a row from ``logits`` (B, V) and advance each live
    row's device state (``state.dev``, the counts) in place, on the device
    alone: row i's k-th generated token consumes ``uniforms[min(k, max_len
    - 1), i]``; ``dev.out`` gets the drawn tokens and the rows with no
    finite logprob. The rules are the JAX ``_sample_and_update``'s: a live
    row appends its token unless it is EOS or the row is full, the counts
    add it and drop the token leaving the row's penalty window, and EOS or
    a full row ends it."""
    dev = state.dev
    logprobs = filter_logits(logits, s, state.counts, dev, blocks)
    u = state.uniforms[dev.n_gen.clamp_max(s.max_len - 1), dev.rows]
    drawn = sample_from_logprobs(logprobs, u)
    dev.out[:, 0] = drawn
    dev.out[:, 1] = ~torch.isfinite(logprobs).any(dim=-1)
    tok = drawn.clamp(0, logits.shape[-1] - 1)     # a dead row raises at the readback
    active = ~dev.done
    appends = active & (tok != s.eos_idx) & (dev.cur < s.max_len)
    at = dev.cur.clamp_max(s.max_len - 1)
    dev.hist[dev.rows, at] = torch.where(appends, tok, dev.hist[dev.rows, at])
    evict_pos = dev.cur - dev.penalty_window          # the token leaving the window
    evict = appends & (dev.n_gen + 1 > dev.penalty_window) & (evict_pos >= 0)
    evict_tok = dev.hist[dev.rows, evict_pos.clamp(0, s.max_len - 1)]
    counts = state.counts
    counts.scatter_add_(1, tok[:, None], appends.to(counts.dtype)[:, None])
    counts.scatter_add_(1, evict_tok[:, None], -evict.to(counts.dtype)[:, None])
    dev.cur += appends
    dev.n_gen += appends
    dev.done |= (active & (tok == s.eos_idx)) | (dev.cur >= s.max_len)
    dev.tok.copy_(dev.hist[dev.rows, (dev.cur - 1).clamp_min(0)])


def read_back(state: DecodeState, s: ArSampling, k: int = 0) -> None:
    """A step's one readback from host buffer ``k`` (``DeviceState.post``;
    the span ``ar.readback``, where the host waits for the device): the
    drawn tokens, from which the host fields follow by ``draw``'s rules. A
    row with no finite logprob raises."""
    with span("ar.readback"):
        out = state.dev.fetch(k)
    if out[:, 1].any():
        raise ValueError("sample_from_logprobs: a row has no finite logprob")
    st, tok = state, out[:, 0]
    idx = np.arange(st.batch)
    active = ~st.done
    appends = active & (tok != s.eos_idx) & (st.cur < s.max_len)
    at = np.minimum(st.cur, s.max_len - 1)
    st.tokens[idx, at] = np.where(appends, tok, st.tokens[idx, at])
    st.cur = st.cur + appends
    st.n_gen = st.n_gen + appends
    st.done = st.done | (active & (tok == s.eos_idx)) | (st.cur >= s.max_len)


def sample_update(state: DecodeState, logits, s: ArSampling, rows: RowSampling) -> None:
    """Sample one token a row from ``logits`` (B, V) and advance each live
    row's state in place (``draw``, then ``read_back``), the device state
    first loaded from the host fields. Spans: the draw (``ar.sample``), then
    its readback (``ar.readback``)."""
    blocks = load_device_state(state, s, rows)
    with span("ar.sample"):
        draw(state, logits, s, blocks)
        state.dev.post(0)
    read_back(state, s)


class Route:
    """A decode step as ``decode_loop`` runs it, feeding every row's last
    token at its cursor through the model and writing its K/V into the
    state's cache: ``direct(state, cur)``, the part a step runs as direct
    calls at the host cursors ``cur`` (B,), or None; ``body(state)``, the
    rest, which returns the (B, V) f32 logits; ``feed(state)``, which
    readies the next step's input after a draw. Where ``graphable`` (and
    ``ar_graphs.takes`` the route), ``body``, the draw and ``feed`` replay
    one CUDA graph a step, keyed by ``name``. Where ``pipelined``, nothing
    of the step but ``direct``'s cursors comes from the host fields, so the
    loop launches it before the previous step is read back. The base has no
    direct part, feeds nothing and is neither graphed nor pipelined."""

    name, direct, graphable, pipelined = "route", None, False, False

    def body(self, state: DecodeState):
        raise NotImplementedError

    def feed(self, state: DecodeState) -> None:
        pass


# decode steps launched while the step before them was not yet read back,
# and steps launched past the end of every row and thrown away (reset with
# reset_counts)
pipelined_steps = 0
discarded_steps = 0


def reset_counts() -> None:
    """Zero this module's step counters and ``ar_graphs``'."""
    global pipelined_steps, discarded_steps
    pipelined_steps = discarded_steps = 0
    ar_graphs.reset_counts()


def launch_cursors(state: DecodeState, s: ArSampling, ahead: bool):
    """The host cursors (B,) the next step runs at, or None where it would
    append to no row. With a step in flight (``ahead``) they are taken past
    it: a live row appends there unless it draws EOS, so it runs at
    ``cur + 1``; a row that draws EOS runs one step at that position, its
    result dropped; a row at ``max_len - 1`` is done after it either way."""
    if not ahead:
        return None if state.done.all() else state.cur
    if (state.done | (state.cur + 1 >= s.max_len)).all():
        return None
    return np.where(state.done, state.cur, state.cur + 1)


def decode_loop(state: DecodeState, s: ArSampling, rows: RowSampling, route: Route,
                n_steps: int | None = None) -> DecodeState:
    """Decode steps of ``route`` until every row is done, or at most
    ``n_steps``; returns ``state``, advanced in place, with no step in
    flight. ``draw`` samples each step's logits, its tokens are copied to
    the host (``DeviceState.post``) and ``read_back`` updates the host
    fields. A ``pipelined`` route runs one step ahead: step i + 1 is
    launched at ``launch_cursors`` before step i is read back, and where
    step i ends every row, step i + 1 is dropped (``discarded_steps``); it
    counts in ``state.steps``, the steps launched. Each launch is the span
    ``ar.step``: the forward ``ar.forward`` (a graphed step with no direct
    part is one replay there), the draw ``ar.sample`` (with a graphed
    ``body``), then ``ar.readback`` of the step before it, or of itself
    where no step follows or the route is not pipelined."""
    global pipelined_steps, discarded_steps
    blocks = load_device_state(state, s, rows)
    route.feed(state)
    graphed = ar_graphs.takes(state, route)
    if graphed and state.graphs is None:
        state.graphs = ar_graphs.StepGraphs(state.counts.device)
    key = (route.name, blocks, s)
    dev = state.dev

    def rest():
        draw(state, route.body(state), s, blocks)
        route.feed(state)

    def launch(cur, k: int) -> None:
        """One step at host cursors ``cur``, its tokens posted to buffer k."""
        if not graphed:
            with span("ar.forward"):
                if route.direct is not None:
                    route.direct(state, cur)
                logits = route.body(state)
            with span("ar.sample"):
                draw(state, logits, s, blocks)
                route.feed(state)
        elif route.direct is None:
            with span("ar.forward"):
                state.graphs.run(key, rest)
        else:
            with span("ar.forward"):
                route.direct(state, cur)
            with span("ar.sample"):
                state.graphs.run(key, rest)
        dev.post(k)

    i, ahead = 0, None          # steps launched; the buffer of the step in flight
    cur = launch_cursors(state, s, False) if n_steps is None or n_steps > 0 else None
    while cur is not None:
        with span("ar.step"):
            launch(cur, i % 2)
            if ahead is not None:
                pipelined_steps += 1
                read_back(state, s, ahead)
                if state.done.all():          # the step just launched is past every row's end
                    discarded_steps += 1
                    i += 1
                    break
            ahead, i = i % 2, i + 1
            more = n_steps is None or i < n_steps
            cur = launch_cursors(state, s, True) if more and route.pipelined else None
            if cur is None:
                read_back(state, s, ahead)
                ahead = None
                if more and not route.pipelined:
                    cur = launch_cursors(state, s, False)
    state.steps += i
    return state


@torch.no_grad()
def decode_step(model: CodecLM, tokens, pos, cache: RingCache):
    """Feed ``tokens`` (B,) at positions ``pos`` (B,) through every layer;
    returns f32 logits (B, V) and writes each row's k/v into its slot
    ``pos % window``. A tensor-parallel copy (``parallel.tp.shard_module``)
    runs its own heads (K7 over its own rings) and reduces, looks up and
    gathers where its modules' ``tp`` says. A ``LatentCache`` takes
    ``decode_step_latent``."""
    if isinstance(cache, LatentCache):
        return decode_step_latent(model, tokens, pos, cache)
    cfg = model.cfg
    dev = cache.k.device
    rows = torch.arange(len(tokens), device=dev)
    pos_t = ints_on_device(pos, dev, torch.int32)
    if model.tp is None:
        x = torch.stack([model.embed.weight[int(t)] for t in tokens])[:, None]
    else:
        x = model.embed_ids(ints_on_device(tokens, dev))[:, None]
    cos, sin = model.ar.rope(pos_t)
    cos, sin = cos[:, None, None], sin[:, None, None]        # (B, 1, 1, D/2)
    slots = torch.remainder(pos_t.long(), cache.window)
    top = max(np.asarray(pos).reshape(-1).tolist())        # sizes K7's clusters
    load = expert_load(model)
    for li, layer in enumerate(model.ar.layers):
        q, k, v = layer.qkv(x, cos, sin)
        attn = decode_attention(q[:, 0], cache.k[li], cache.v[li], pos_t, k[:, 0], v[:, 0],
                                max_pos=top)
        cache.k[li, rows, slots] = k[:, 0]
        cache.v[li, rows, slots] = v[:, 0]
        x = layer.finish(x, attn[:, None], True, None if load is None else load[li])
    return model.ar.head(x)[:, 0].float()


@torch.no_grad()
def decode_step_latent(model: CodecLM, tokens, pos, cache: LatentCache):
    """``decode_step`` of a latent-attention backbone (``latent_step``) on
    host tokens and positions, eager (the decode loop runs ``LatentStep``)."""
    x = torch.stack([model.embed.weight[int(t)] for t in tokens])
    return latent_step(model, x, ints_on_device(pos, cache.ckv.device, torch.int32), cache)


class RingStep(Route):
    """The bf16 ring's decode step as ``decode_loop`` runs it: ``decode_step``
    on each row's last token and cursor from the host fields, since K7 sizes
    its clusters from the host's positions; never graphed."""

    name = "ring"

    def __init__(self, model: CodecLM, cache: RingCache):
        self.model, self.cache = model, cache

    def body(self, state: DecodeState):
        idx = np.arange(state.batch)
        return decode_step(self.model, state.tokens[idx, np.maximum(state.cur - 1, 0)],
                           state.cur, self.cache)


class LatentStep(Route):
    """A latent-attention backbone's decode step as ``decode_loop`` runs it:
    each row's last token embedded and its cursor taken from the device
    state, then ``latent_step``, all on the device: on the card the step
    and its draw are one CUDA graph replay (``models/ar_graphs``); pipelined,
    since nothing of it comes from the host."""

    name, graphable, pipelined = "latent", True, True

    def __init__(self, model: CodecLM, cache: LatentCache):
        self.model, self.cache = model, cache

    def body(self, state: DecodeState):
        dev = state.dev
        return latent_step(self.model, self.model.embed.weight[dev.tok],
                           dev.cur.to(torch.int32), self.cache)


class ModelEngine:
    """The decode engine of the model as loaded, every entry point's
    default: a ``RingCache`` run by ``RingStep`` (K7 on the card), or for
    latent attention (``cfg.attention == "mla"``) a ``LatentCache`` run by
    ``LatentStep``; any number of rows, a window of ``min(sliding_window,
    max_len + 1)`` slots. ``models/ar_decode_fused.FusedEngine``, the
    quantized engine, answers the same three questions."""

    def fit(self, cfg: CodecLMConfig, s: ArSampling, rows: int, pool: bool = False) -> int:
        """The window of a cache of ``rows`` rows under ``s`` (``pool``: the
        rows are a serving pool's); raises ValueError where the engine cannot
        take them."""
        return min(cfg.sliding_window, s.max_len + 1)

    def cache(self, cfg: CodecLMConfig, rows: int, window: int, dtype, device,
              n_heads: int | None = None):
        """The empty cache of ``rows`` rows (``make_cache``)."""
        return make_cache(cfg, rows, window, dtype, device, n_heads)

    def step(self, model: CodecLM, cache) -> Route:
        """The route that steps ``model`` on ``cache``."""
        return (LatentStep if model.cfg.attention == "mla" else RingStep)(model, cache)


MODEL_ENGINE = ModelEngine()


def latent_step(model: CodecLM, x, pos_t, cache: LatentCache):
    """One decode token a row of a latent-attention backbone, every shape
    fixed by the cache and nothing read back (a CUDA graph captures it):
    x (B, D) the rows' embedded tokens at positions ``pos_t`` (B,) int32 on
    the device. Each layer writes the rows' latent and roped key into slot
    ``pos % window``, then attends in the absorbed form over the whole
    ring, its invalid slots masked (the current token's own slot is
    valid); expert layers run K10, tallying into ``expert_load``. Returns
    f32 logits (B, V)."""
    w = cache.window
    rows = torch.arange(x.shape[0], device=x.device)
    cos, sin = model.ar.rope(pos_t)
    cos, sin = cos[:, None, None], sin[:, None, None]        # (B, 1, 1, rope/2)
    slots = torch.remainder(pos_t.long(), w)
    bias = torch.zeros((x.shape[0], 1, w), dtype=torch.float32, device=x.device).masked_fill(
        ~ring_valid(pos_t, w, False)[:, None], float("-inf"))
    load = expert_load(model)
    x = x[:, None]
    for li, layer in enumerate(model.ar.layers):
        a = layer.attention
        h = layer.attention_norm(x)
        c, k_pe = a.latent(h, cos, sin)
        cache.ckv[li, rows, slots] = torch.cat([c, k_pe], dim=-1)[:, 0]
        q_nope, q_pe = a.queries(h, cos, sin)
        attn = a.absorbed(q_nope[:, 0], q_pe[:, 0], cache.ckv[li], bias)
        x = layer.finish(x, attn[:, None], True, None if load is None else load[li])
    return model.ar.head(x)[:, 0].float()


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
    per-layer (k, v), each (1, P_i + 1, H, D), or (c, k_pe) of latent
    attention, a row)."""
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
                  est_lens=None, rows: RowSampling | None = None,
                  engine=None) -> DecodeState:
    """Prefill ``prompts`` (each row at its own length, ``prefill_rows``)
    into the cache ``engine`` (default ``MODEL_ENGINE``) keeps for B rows and
    sample each row's first token: a ready-to-decode state. A bf16 ring
    takes the prefill's dtype and heads (a tensor-parallel rank's own).
    ``uniforms`` (max_len, B) on the model's device; ``rows`` default
    ``rows_from_sampling(s, B)``. The span ``ar.prefill``."""
    engine = engine or MODEL_ENGINE
    cfg = model.cfg
    prompts = [np.asarray(p, np.int64) for p in prompts]
    window = engine.fit(cfg, s, len(prompts))
    with span("ar.prefill"):
        logits, kvs = prefill_rows(model, prompts, spk_codes_list, window)
        k0 = kvs[0][0][0]                           # (1, P + 1, H, D): H this rank's heads
        cache = engine.cache(cfg, len(prompts), window, k0.dtype, logits.device,
                             n_heads=k0.shape[2])
        for r, kv in enumerate(kvs):
            cache.write_prompt(r, kv)
        state = new_state(prompts, s, cfg.n_vocab, uniforms, cache, est_lens)
        sample_update(state, logits, s, rows or rows_from_sampling(s, len(prompts)))
    return state


def prefill_row(model: CodecLM, s: ArSampling, prompt, spk_codes, uniforms, est_len=None,
                rows: RowSampling | None = None, engine=None) -> DecodeState:
    """One request's prefill for a serving pool: a one-row state with its
    first token sampled (``insert_row`` puts it into a pool). ``uniforms``
    (max_len,) or (max_len, 1) on the model's device; ``rows`` (one row)
    carries the request's own sampling values."""
    return prefill_state(model, s, [prompt], [spk_codes], uniforms.reshape(-1, 1),
                         None if est_len is None else [est_len], rows, engine)


@torch.no_grad()
def decode_chunk(model: CodecLM, s: ArSampling, state: DecodeState, n_steps: int | None,
                 rows: RowSampling | None = None, engine=None) -> DecodeState:
    """At most ``n_steps`` decode steps of every row of ``state`` on
    ``engine``'s route (fewer when every row is done; None: until then): a
    serving pool's scheduling quantum. Rows decode independently, so
    chunked decoding gives each row the tokens of one uninterrupted run."""
    return decode_loop(state, s, rows or rows_from_sampling(s, state.batch),
                       (engine or MODEL_ENGINE).step(model, state.cache), n_steps)


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
    field, the slot's rings (and scales) whole. Returns ``state``."""
    for name in ("tokens", "cur", "n_gen", "est_len", "done"):
        getattr(state, name)[b] = getattr(row, name)[0]
    state.counts[b] = row.counts[0]
    state.uniforms[:, b] = row.uniforms[:, 0]
    state.cache.put_row(b, row.cache)
    return state


def make_parked_state(cfg: CodecLMConfig, s: ArSampling, bs: int, dtype, device,
                      engine=None) -> DecodeState:
    """A state of ``bs`` free rows (all done, at cursor 0, zero tokens,
    counts and uniforms) for a serving pool, its cache ``engine``'s (a bf16
    ring of ``dtype``): a parked row keeps decoding at its frozen position
    and appends nothing."""
    engine = engine or MODEL_ENGINE
    window = engine.fit(cfg, s, bs, pool=True)
    return DecodeState(tokens=np.zeros((bs, s.max_len), np.int64), cur=np.zeros(bs, np.int64),
                       n_gen=np.zeros(bs, np.int64), est_len=np.zeros(bs, np.int64),
                       done=np.ones(bs, bool),
                       counts=torch.zeros((bs, cfg.n_vocab), dtype=torch.int32, device=device),
                       uniforms=torch.zeros((s.max_len, bs), dtype=torch.float32, device=device),
                       cache=engine.cache(cfg, bs, window, dtype, device))


@torch.no_grad()
def ar_generate_batched(model: CodecLM, prompts, spk_codes_list, *, sampling: ArSampling,
                        uniforms=None, generator: torch.Generator | None = None,
                        seed: int = 0, est_lens=None, rows: RowSampling | None = None,
                        engine=None):
    """Complete each of ``prompts`` (1-D token ids) conditioned on its
    ``spk_codes_list`` entry (S_i, 8) on ``engine`` (default
    ``MODEL_ENGINE``). Returns one (np.ndarray sequence incl. the prompt and
    without the closing EOS, n_generated) per row.

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
    b = len(prompts)
    rows = rows or rows_from_sampling(s, b)
    u = uniform_stream(uniforms, generator, seed, s.max_len, b, model.embed.weight.device)
    state = prefill_state(model, s, prompts, spk_codes_list, u[:, :b], est_lens, rows, engine)
    return decode_chunk(model, s, state, None, rows, engine).results()


def ar_generate(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                uniforms=None, generator: torch.Generator | None = None, seed: int = 0,
                engine=None):
    """Complete one ``prompt`` (1-D token ids) conditioned on ``spk_codes``
    (S, 8): ``ar_generate_batched`` with one row, the k-th generated token
    consuming ``uniforms[k]``. Returns (np.ndarray sequence incl. the prompt
    and without the closing EOS, n_generated)."""
    return ar_generate_batched(model, [prompt], [spk_codes], sampling=sampling,
                               uniforms=uniforms, generator=generator, seed=seed,
                               engine=engine)[0]


class NoCacheStep(Route):
    """``ar_generate_nocache``'s step: the full prefill over the one row's
    (1, max_len) token buffer (the banded sliding-window mask; causality
    leaves the cursor's logits to the tokens before it), the logits at its
    cursor."""

    name = "nocache"

    def __init__(self, model: CodecLM, spk_vec):
        self.model, self.spk_vec = model, spk_vec

    def body(self, state: DecodeState):
        buf = torch.as_tensor(state.tokens, device=self.spk_vec.device)
        all_logits, _ = self.model.prefill(buf, self.spk_vec)
        return all_logits[:, int(state.cur[0])].float()


@torch.no_grad()
def ar_generate_nocache(model: CodecLM, prompt, spk_codes, *, sampling: ArSampling,
                        uniforms=None, generator: torch.Generator | None = None,
                        seed: int = 0):
    """``ar_generate`` without a cache (the reference's ``use_kv_cache=False``):
    every step runs the full prefill and samples at the cursor
    (``NoCacheStep``). The same API and uniform stream as ``ar_generate``."""
    s = sampling
    dev = model.embed.weight.device
    u = uniform_stream(uniforms, generator, seed, s.max_len, 1, dev)
    spk = torch.as_tensor(np.asarray(spk_codes, np.int64), device=dev)[None]
    state = new_state([np.asarray(prompt, np.int64)], s, model.cfg.n_vocab, u, None)
    rows = rows_from_sampling(s, 1)
    step = NoCacheStep(model, model.spk_embedding(spk))
    sample_update(state, step.body(state), s, rows)
    return decode_loop(state, s, rows, step).results()[0]
