"""Quantized AR decode engine over one or more rows, ``ar_backend="fused"``
(W8A8) and ``"fused4"`` (W4A8) (counterpart of
``mars5_tts_tpu/models/ar_decode_fused.py``: ``ar_generate_fused`` and
``ar_generate_fused_batched``).

Each row's prompt is prefilled through the model as loaded
(``CodecLM.prefill``, one row at a time, as in ``models/ar_decode``); its K/V
rows are quantized per position into the row's int8 ring of ``window``
slots with per-position scales. Every step then
runs each row's last token: embed -> bf16 -> kernel K2
(``ops/kernels/decode_layer.fused_decode_layers``, all rows in one call, the
weight stream shared) -> final RMSNorm of the bf16-rounded rows -> output
head -> the shared sampling loop of ``models/ar_decode``, and each row's new
K/V rows are quantized into its slot ``position % window``. The head is the
weight-only int8 product (``ops/quant.linear_q8``) or, with ``head4``,
kernel K8 (``ops/kernels/head4.head4_logits``).

Unlike the JAX engine, the prompts are not padded to buckets and a short
batch is not padded with parked rows (both only fit XLA's static shapes):
the engine runs exactly the rows it is given, at most ``dims.batch``.

The rows share the decode loop and resumable state of ``models/ar_decode``
(``DecodeState`` with a ``FusedCache``): ``prefill_fused`` is the batched
prefill, ``decode_chunk_fused`` runs at most n steps of a pool (one K2 call
a step for all its rows), ``make_parked_state_fused`` is a pool of free
rows and ``extract_fused_row`` / ``insert_fused_row`` move a row between
states, an insert overwriting the slot's int8 rings and scales whole. A
row's tokens do not depend on the rows beside it: K2's per-row sums are
integer or f64 sums whatever the batch, and the int8 head runs at
``HEAD_ROWS`` rows whatever the batch (cuBLAS picks the head's f32 GEMM
kernel by the row count, so a row's logits would otherwise round one way in
a one-row step and another in a pool's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.decode_layer import (MAX_BATCH, FusedDims, build_fused_pack,
                                        fused_decode_layers, make_dims, quantize_kv_rows)
from ..ops.kernels.head4 import head4_logits, pack_head4
from ..ops.norms import rms_norm
from ..ops.quant import linear_q8, quantize_weight
from .ar import CodecLM, CodecLMConfig
from .ar_decode import (ArSampling, DecodeState, RowSampling, decode_loop, extract_row,
                        insert_row, new_state, parked_fields, prefill_rows, rows_from_sampling,
                        sample_rows, sample_update, uniform_stream)


@torch.no_grad()
def prepare_fused(codeclm: CodecLM, max_len: int, wbits: int = 8, head4: bool = False,
                  batch: int = 1, int4_mse: bool = True):
    """The decode-time bundle of ``codeclm``: (pack, dims). The pack holds the
    quantized backbone (``build_fused_pack``; ``int4_mse`` as there), the
    output head (int8 per-row, or nibble-packed int4 with ``head4``, which
    needs ``wbits=4``), and the model's final norm weight and embedding
    table. The pack does not depend on ``batch`` (the rows a batched step
    takes, ``dims.batch``)."""
    if head4 and wbits != 4:
        raise ValueError("the int4 head (head4) goes with the int4 backbone (wbits=4)")
    dims = make_dims(codeclm.cfg, max_len, wbits, batch)
    fp = build_fused_pack(codeclm, dims, int4_mse)
    out_w = codeclm.ar.output.weight.detach()
    if head4:
        fp["head4_p"], fp["head4_s"] = pack_head4(out_w)
    else:
        fp["head_q"], fp["head_s"] = quantize_weight(out_w)
    fp["final_norm"] = codeclm.ar.norm.weight.detach()
    fp["embed"] = codeclm.embed.weight.detach()
    return fp, dims


HEAD_ROWS = MAX_BATCH    # rows the int8 head always runs at


def head_logits(fp, h, n_vocab: int):
    """The output head: K8 when the pack carries the int4 head, else the
    int8 weight-only product; (B, V) f32."""
    if "head4_p" in fp:
        return head4_logits(h, fp["head4_p"], fp["head4_s"], n_vocab=n_vocab)
    return linear_q8(h, fp["head_q"], fp["head_s"]).float()


def final_logits(fp, h, cfg):
    """(B, d) f32 hidden rows -> (B, V) f32 logits: the final RMSNorm of the
    bf16-rounded rows, then the head. The int8 head runs at ``HEAD_ROWS``
    rows (the real ones, then zero rows) so that each row's logits are those
    of its own one-row step; K8 takes the real rows alone (its sums are
    integer sums), and the norm's row sums do not depend on the row count."""
    b = h.shape[0]
    hn = rms_norm(h.to(torch.bfloat16), fp["final_norm"], cfg.norm_eps)
    if "head4_p" in fp:
        return head_logits(fp, hn, cfg.n_vocab)
    return head_logits(fp, torch.nn.functional.pad(hn, (0, 0, 0, HEAD_ROWS - b)),
                       cfg.n_vocab)[:b]


class FusedCache:
    """int8 K/V rings (L, B, window, d) with per-position scales
    (L, B, 2, window) (row 0 K, row 1 V)."""

    def __init__(self, dims: FusedDims, device, batch: int = 1):
        L, W, d = dims.n_layers, dims.window, dims.dim
        self.k = torch.zeros((L, batch, W, d), dtype=torch.int8, device=device)
        self.v = torch.zeros_like(self.k)
        self.scales = torch.zeros((L, batch, 2, W), dtype=torch.float32, device=device)

    def write_prompt(self, row: int, kv) -> None:
        """A prefill's per-layer (k, v), each (1, P + 1, H, D), quantized per
        position into slots [0, P + 1) of ``row``."""
        k8, ks = quantize_kv_rows(torch.stack([k[0].flatten(1) for k, _ in kv]))
        v8, vs = quantize_kv_rows(torch.stack([v[0].flatten(1) for _, v in kv]))
        p = k8.shape[1]
        self.k[:, row, :p] = k8
        self.v[:, row, :p] = v8
        self.scales[:, row, 0, :p] = ks
        self.scales[:, row, 1, :p] = vs

    def write_rows(self, slots, k, v) -> None:
        """Quantize (L, B, d) K/V rows into each row's slot ``slots`` (B host
        ints; indexing with them needs no host-to-device copy)."""
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        for r, slot in enumerate(int(x) for x in slots):
            self.k[:, r, slot] = k8[:, r]
            self.v[:, r, slot] = v8[:, r]
            self.scales[:, r, 0, slot] = ks[:, r]
            self.scales[:, r, 1, slot] = vs[:, r]

    def take_row(self, j: int) -> "FusedCache":
        """A one-row copy of row ``j``: its rings and scales."""
        out = FusedCache.__new__(FusedCache)
        out.k, out.v = self.k[:, j:j + 1].clone(), self.v[:, j:j + 1].clone()
        out.scales = self.scales[:, j:j + 1].clone()
        return out

    def put_row(self, b: int, row: "FusedCache") -> None:
        """Overwrite row ``b``'s rings and scales whole with the one-row
        ``row``'s (a parked or finished row's stale slots never survive)."""
        self.k[:, b] = row.k[:, 0]
        self.v[:, b] = row.v[:, 0]
        self.scales[:, b] = row.scales[:, 0]


def fused_step(fp, dims: FusedDims, cfg, tokens, pos, cache: FusedCache):
    """One token of each row (``tokens`` and ``pos``: an int each, or B ints)
    -> (B, V) f32 logits; each row's K/V go to its slot pos % window."""
    pos = np.atleast_1d(np.asarray(pos, np.int64))
    x = torch.stack([fp["embed"][int(t)] for t in np.atleast_1d(tokens)]).to(torch.bfloat16)
    h, k_new, v_new = fused_decode_layers(fp, x, pos, cache.k, cache.v, cache.scales,
                                          dims=dims, norm_eps=cfg.norm_eps)
    logits = final_logits(fp, h, cfg)
    cache.write_rows(pos % dims.window, k_new, v_new)
    return logits


@torch.no_grad()
def prefill_fused(codeclm: CodecLM, dims: FusedDims, s: ArSampling, prompts, spk_codes_list,
                  uniforms, est_lens=None, rows: RowSampling | None = None) -> DecodeState:
    """The batched prefill into the quantized engine's state: each prompt
    through the model as loaded at its own length (``prefill_rows``), its
    K/V quantized into its row of a ``FusedCache`` of B = len(prompts) rows,
    each row's first token sampled. ``uniforms`` (max_len, B) on the
    device; ``rows`` default ``rows_from_sampling(s, B)``."""
    cfg = codeclm.cfg
    b = len(prompts)
    if not 1 <= b <= dims.batch:
        raise ValueError(f"{b} prompts for an engine of {dims.batch} rows")
    if dims.window < min(cfg.sliding_window, s.max_len + 1):
        raise ValueError(f"the pack's window {dims.window} is too short for max_len "
                         f"{s.max_len}")
    prompts = [np.asarray(p, np.int64) for p in prompts]
    logits, kvs = prefill_rows(codeclm, prompts, spk_codes_list, dims.window)
    cache = FusedCache(dims, logits.device, b)
    for r, kv in enumerate(kvs):
        cache.write_prompt(r, kv)
    state = new_state(prompts, s, cfg.n_vocab, uniforms, cache, est_lens)
    sample_update(state, logits, s, rows or rows_from_sampling(s, b))
    return state


def make_parked_state_fused(cfg: CodecLMConfig, dims: FusedDims, s: ArSampling,
                            device) -> DecodeState:
    """A state of ``dims.batch`` free rows (all done) on the quantized
    engine, for a serving pool."""
    return DecodeState(**parked_fields(s, dims.batch, cfg.n_vocab, device),
                       cache=FusedCache(dims, device, dims.batch))


# a row moves between quantized states as between bf16 ones: the FusedCache
# copies and overwrites its rings and scales whole
extract_fused_row = extract_row
insert_fused_row = insert_row


@torch.no_grad()
def decode_chunk_fused(fp, dims: FusedDims, cfg, s: ArSampling, state: DecodeState,
                       n_steps: int, rows: RowSampling | None = None) -> DecodeState:
    """At most ``n_steps`` decode steps of every row of ``state`` on the
    quantized engine, one K2 call a step for all rows (fewer steps when
    every row is done)."""
    return decode_loop(state, s, rows or rows_from_sampling(s, state.batch),
                       lambda t, pos: fused_step(fp, dims, cfg, t, pos, state.cache), n_steps)


@torch.no_grad()
def ar_generate_fused_batched(codeclm: CodecLM, fp, dims: FusedDims, prompts,
                              spk_codes_list, *, sampling: ArSampling, uniforms=None,
                              generator: torch.Generator | None = None, seed: int = 0,
                              est_lens=None, rows: RowSampling | None = None):
    """Generation of up to ``dims.batch`` rows through the quantized engine,
    one K2 call a step for all rows; the API, uniform stream and per-row
    state of ``models/ar_decode.ar_generate_batched``. ``fp, dims`` come from
    ``prepare_fused`` with ``max_len >= sampling.max_len``."""
    s = sampling
    b = len(prompts)
    rows = rows or rows_from_sampling(s, b)
    u = uniform_stream(uniforms, generator, seed, s.max_len, b, fp["embed"].device)[:, :b]
    state = prefill_fused(codeclm, dims, s, prompts, spk_codes_list, u, est_lens, rows)
    return sample_rows(state, s, rows,
                       lambda t, pos: fused_step(fp, dims, codeclm.cfg, t, pos, state.cache))


def ar_generate_fused(codeclm: CodecLM, fp, dims: FusedDims, prompt, spk_codes, *,
                      sampling: ArSampling, uniforms=None,
                      generator: torch.Generator | None = None, seed: int = 0):
    """One row through the quantized engine (``ar_generate_fused_batched``
    with one row); the API and the uniform stream of
    ``models/ar_decode.ar_generate``."""
    return ar_generate_fused_batched(codeclm, fp, dims, [prompt], [spk_codes],
                                     sampling=sampling,
                                     uniforms=uniforms, generator=generator, seed=seed)[0]
