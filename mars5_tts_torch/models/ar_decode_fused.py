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
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.decode_layer import (FusedDims, build_fused_pack, fused_decode_layers,
                                        make_dims, quantize_kv_rows)
from ..ops.kernels.head4 import head4_logits, pack_head4
from ..ops.norms import rms_norm
from ..ops.quant import linear_q8, quantize_weight
from .ar import CodecLM
from .ar_decode import ArSampling, prefill_rows, sample_rows, uniform_stream


@torch.no_grad()
def prepare_fused(codeclm: CodecLM, max_len: int, wbits: int = 8, head4: bool = False,
                  batch: int = 1):
    """The decode-time bundle of ``codeclm``: (pack, dims). The pack holds the
    quantized backbone (``build_fused_pack``), the output head (int8 per-row,
    or nibble-packed int4 with ``head4``, which needs ``wbits=4``), and the
    model's final norm weight and embedding table. The pack does not depend
    on ``batch`` (the rows a batched step takes, ``dims.batch``)."""
    if head4 and wbits != 4:
        raise ValueError("the int4 head (head4) goes with the int4 backbone (wbits=4)")
    dims = make_dims(codeclm.cfg, max_len, wbits, batch)
    fp = build_fused_pack(codeclm, dims)
    out_w = codeclm.ar.output.weight.detach()
    if head4:
        fp["head4_p"], fp["head4_s"] = pack_head4(out_w)
    else:
        fp["head_q"], fp["head_s"] = quantize_weight(out_w)
    fp["final_norm"] = codeclm.ar.norm.weight.detach()
    fp["embed"] = codeclm.embed.weight.detach()
    return fp, dims


def head_logits(fp, h, n_vocab: int):
    """The output head: K8 when the pack carries the int4 head, else the
    int8 weight-only product; (B, V) f32."""
    if "head4_p" in fp:
        return head4_logits(h, fp["head4_p"], fp["head4_s"], n_vocab=n_vocab)
    return linear_q8(h, fp["head_q"], fp["head_s"]).float()


class FusedCache:
    """int8 K/V rings (L, B, window, d) with per-position scales
    (L, B, 2, window) (row 0 K, row 1 V)."""

    def __init__(self, dims: FusedDims, device, batch: int = 1):
        L, W, d = dims.n_layers, dims.window, dims.dim
        self.k = torch.zeros((L, batch, W, d), dtype=torch.int8, device=device)
        self.v = torch.zeros_like(self.k)
        self.scales = torch.zeros((L, batch, 2, W), dtype=torch.float32, device=device)

    def write(self, row: int, k, v) -> None:
        """Quantize (L, P, d) K/V rows into slots [0, P) of ``row``."""
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        p = k.shape[1]
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


def fused_step(fp, dims: FusedDims, cfg, tokens, pos, cache: FusedCache):
    """One token of each row (``tokens`` and ``pos``: an int each, or B ints)
    -> (B, V) f32 logits; each row's K/V go to its slot pos % window."""
    pos = np.atleast_1d(np.asarray(pos, np.int64))
    x = torch.stack([fp["embed"][int(t)] for t in np.atleast_1d(tokens)]).to(torch.bfloat16)
    h, k_new, v_new = fused_decode_layers(fp, x, pos, cache.k, cache.v, cache.scales,
                                          dims=dims, norm_eps=cfg.norm_eps)
    hn = rms_norm(h.to(torch.bfloat16), fp["final_norm"], cfg.norm_eps)
    logits = head_logits(fp, hn, cfg.n_vocab)
    cache.write_rows(pos % dims.window, k_new, v_new)
    return logits


@torch.no_grad()
def ar_generate_fused_batched(codeclm: CodecLM, fp, dims: FusedDims, prompts,
                              spk_codes_list, *, sampling: ArSampling, uniforms=None,
                              generator: torch.Generator | None = None, seed: int = 0,
                              est_lens=None):
    """Generation of up to ``dims.batch`` rows through the quantized engine,
    one K2 call a step for all rows; the API, uniform stream and per-row
    state of ``models/ar_decode.ar_generate_batched``. ``fp, dims`` come from
    ``prepare_fused`` with ``max_len >= sampling.max_len``."""
    s = sampling
    cfg = codeclm.cfg
    dev = fp["embed"].device
    b = len(prompts)
    if not 1 <= b <= dims.batch:
        raise ValueError(f"{b} prompts for an engine of {dims.batch} rows")
    if dims.window < min(cfg.sliding_window, s.max_len + 1):
        raise ValueError(f"the pack's window {dims.window} is too short for max_len "
                         f"{s.max_len}")
    prompts = [np.asarray(p, np.int64) for p in prompts]
    logits, kvs = prefill_rows(codeclm, prompts, spk_codes_list, dims.window)
    uniforms = uniform_stream(uniforms, generator, seed, s.max_len, b, dev)[:, :b]
    cache = FusedCache(dims, dev, b)
    for r, row in enumerate(kvs):
        cache.write(r, torch.stack([k[0].flatten(1) for k, _ in row]),
                    torch.stack([v[0].flatten(1) for _, v in row]))
    return sample_rows(logits, prompts, s, uniforms,
                       lambda t, pos: fused_step(fp, dims, cfg, t, pos, cache), est_lens)


def ar_generate_fused(codeclm: CodecLM, fp, dims: FusedDims, prompt, spk_codes, *,
                      sampling: ArSampling, uniforms=None,
                      generator: torch.Generator | None = None, seed: int = 0):
    """One row through the quantized engine (``ar_generate_fused_batched``
    with one row); the API and the uniform stream of
    ``models/ar_decode.ar_generate``."""
    return ar_generate_fused_batched(codeclm, fp, dims, [prompt], [spk_codes],
                                     sampling=sampling,
                                     uniforms=uniforms, generator=generator, seed=seed)[0]
