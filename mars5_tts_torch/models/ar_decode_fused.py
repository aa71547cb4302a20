"""Quantized AR decode engine at batch size 1, ``ar_backend="fused"`` (W8A8)
and ``"fused4"`` (W4A8) (counterpart of the bs=1 half of
``mars5_tts_tpu/models/ar_decode_fused.py``).

The prompt is prefilled through the model as loaded (``CodecLM.prefill``);
its K/V rows are quantized per position into an int8 ring of ``window``
slots with per-position scales. Every generated token then runs embed ->
bf16 -> kernel K2 (``ops/kernels/decode_layer.fused_decode_layers``) ->
final RMSNorm of the bf16-rounded row -> output head -> the shared sampling
loop of ``models/ar_decode``, and the token's new K/V rows are quantized into
slot ``position % window``. The head is the weight-only int8 product
(``ops/quant.linear_q8``) or, with ``head4``, kernel K8
(``ops/kernels/head4.head4_logits``).

Unlike the JAX engine, the prompt is not padded to a bucket (the buckets only
limit XLA compiles).
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
from .ar_decode import ArSampling, prefill_prompt, sample_tokens, uniform_stream


@torch.no_grad()
def prepare_fused(codeclm: CodecLM, max_len: int, wbits: int = 8, head4: bool = False):
    """The decode-time bundle of ``codeclm``: (pack, dims). The pack holds the
    quantized backbone (``build_fused_pack``), the output head (int8 per-row,
    or nibble-packed int4 with ``head4``, which needs ``wbits=4``), and the
    model's final norm weight and embedding table."""
    if head4 and wbits != 4:
        raise ValueError("the int4 head (head4) goes with the int4 backbone (wbits=4)")
    dims = make_dims(codeclm.cfg, max_len, wbits)
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
    int8 weight-only product; (1, V) f32."""
    if "head4_p" in fp:
        return head4_logits(h, fp["head4_p"], fp["head4_s"], n_vocab=n_vocab)
    return linear_q8(h, fp["head_q"], fp["head_s"]).float()


class FusedCache:
    """int8 K/V rings (L, window, d) with per-position scales (L, 2, window)."""

    def __init__(self, dims: FusedDims, device):
        L, W, d = dims.n_layers, dims.window, dims.dim
        self.k = torch.zeros((L, W, d), dtype=torch.int8, device=device)
        self.v = torch.zeros_like(self.k)
        self.scales = torch.zeros((L, 2, W), dtype=torch.float32, device=device)

    def write(self, start: int, k, v) -> None:
        """Quantize (L, P, d) K/V rows into slots [start, start + P)."""
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        end = start + k.shape[1]
        self.k[:, start:end] = k8
        self.v[:, start:end] = v8
        self.scales[:, 0, start:end] = ks
        self.scales[:, 1, start:end] = vs


def fused_step(fp, dims: FusedDims, cfg, token: int, pos: int, cache: FusedCache):
    """One token at ``pos``: (1, V) f32 logits; its K/V go to slot pos % window."""
    x = fp["embed"][token].to(torch.bfloat16)[None]
    h, k_new, v_new = fused_decode_layers(fp, x, pos, cache.k, cache.v, cache.scales,
                                          dims=dims, norm_eps=cfg.norm_eps)
    hn = rms_norm(h.to(torch.bfloat16), fp["final_norm"], cfg.norm_eps)
    logits = head_logits(fp, hn, cfg.n_vocab)
    cache.write(pos % dims.window, k_new, v_new)
    return logits


@torch.no_grad()
def ar_generate_fused(codeclm: CodecLM, fp, dims: FusedDims, prompt, spk_codes, *,
                      sampling: ArSampling, uniforms=None,
                      generator: torch.Generator | None = None, seed: int = 0):
    """bs=1 generation through the quantized engine; the API and the uniform
    stream of ``models/ar_decode.ar_generate``. ``fp, dims`` come from
    ``prepare_fused`` with ``max_len >= sampling.max_len``."""
    s = sampling
    cfg = codeclm.cfg
    dev = fp["embed"].device
    prompt = np.asarray(prompt, np.int64)
    if dims.window < min(cfg.sliding_window, s.max_len + 1):
        raise ValueError(f"the pack's window {dims.window} is too short for max_len "
                         f"{s.max_len}")
    all_logits, kvs = prefill_prompt(codeclm, prompt, spk_codes, dims.window)
    uniforms = uniform_stream(uniforms, generator, seed, s.max_len, dev)
    cache = FusedCache(dims, dev)
    p1 = len(prompt) + 1
    cache.write(0, torch.stack([k[0].reshape(p1, -1) for k, _ in kvs]),
                torch.stack([v[0].reshape(p1, -1) for _, v in kvs]))
    return sample_tokens(all_logits[:, len(prompt)].float(), prompt, s, uniforms,
                         lambda t, pos: fused_step(fp, dims, cfg, t, pos, cache))
