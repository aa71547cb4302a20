"""The AR of ``ar_backend="fused4"``: the prompt's forward pass with the
weights as drawn, each later token through the W4A8 decode step of kernel
K2. Each GEMM's weights int4 per row with the clip search (each half of the
input axis on its own, ``w2`` whole rows;
``mars5_tts_torch/ops/kernels/decode_layer.py`` ``build_fused_pack``), its
input rows int8; the K/V of every earlier position held int8 per position
(``models/ar_decode_fused.py`` ``FusedCache``), the current token's own K/V
unquantized (``decode_layer.fused_step_ref``); the output head int8
weight-only (``prepare_fused``).

The control is this route one precision down: every quantity the route
makes int8 (the activations, the cached K/V, the head) int4; the weights
are int4 already.
"""

from __future__ import annotations

import torch

from . import quant
from .ar import decode_logits, layer_weights, prefill, spk_vector

INT8, INT4 = 127, 7
W4 = ("attention.wq.weight", "attention.wk.weight", "attention.wv.weight",
      "attention.wo.weight", "feed_forward.w1.weight", "feed_forward.w3.weight")


def decode_weights(p, cfg, levels: int, int4_mse: bool):
    """The decode step's weights per layer, dequantized as the K2 pack holds
    them, and the output head's (``levels``: the head's)."""
    out = []
    for i in range(cfg["n_layers"]):
        w = dict(layer_weights(p, i))
        for k in W4:
            w[k] = quant.int4_halves(w[k], int4_mse)
        w["feed_forward.w2.weight"] = quant.int4(w["feed_forward.w2.weight"], int4_mse)
        out.append(w)
    return out, quant.rows(p["ar.output.weight"], levels)


def prepare(p, cfg, options, control: bool = False) -> dict:
    """The weights as the route holds them (``p``, the state as drawn, for
    the prefill; the decode step's per layer; the head's) and its levels."""
    levels = INT4 if control else INT8
    layers, head = decode_weights(p, cfg, levels, options.get("int4_mse", True))
    return {"p": p, "layers": layers, "head": head, "levels": levels}


def served_logits(prep, cfg, prompt, spk_codes, served):
    """(N, V) float32 logits that chose each of the N ``served`` tokens after
    ``prompt`` (P,), with the speaker of ``spk_codes`` (S, 8)."""
    p = prep["p"]
    x = torch.cat([spk_vector(p, spk_codes, cfg)[None], p["embed.weight"][prompt]])
    first, kvs = prefill(p, cfg, x)
    if len(served) == 1:
        return first[None]
    rest = decode_logits(p, cfg, prep["layers"], prep["head"], kvs, served[:-1], x.shape[0],
                         prep["levels"])
    return torch.cat([first[None], rest])
