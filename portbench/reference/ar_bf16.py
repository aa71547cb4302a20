"""The AR of ``ar_backend="bf16"``: the model as loaded, prefill and every
decode step, so the reference is one float32 forward pass over the prompt
and the served tokens, teacher-forced. It serves both blocks the route runs:
the MARS5 release's Mistral block (``ar.py``'s speaker vector and weights;
the forward written out here) and the DeepSeek-V2 block (``attention ==
"mla"``, ``mla_moe.py``).

The control is this route one precision down: every GEMM operand of the
decoder stack and the head rounded to float8 e4m3 with a scale a row
(``mla_moe.fp8_rows``); the speaker encoder stays float32.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import mla_moe
from .ar import layer_weights, spk_vector
from .layers import attention, rms_norm, rope
from .mla_moe import lin


def prepare(p, cfg, options, control: bool = False) -> dict:
    """The weights as drawn (the route quantizes none) and whether to round."""
    return {"p": p, "control": control}


def mha_logits(p, cfg, x, control: bool = False):
    """The MARS5 decoder stack over x (N, D), embedded with the speaker row
    first, causal within the sliding window: the (N, V) logits."""
    n, d, hd, eps = x.shape[0], cfg["dim"], cfg["head_dim"], cfg["norm_eps"]
    pos = torch.arange(n, device=x.device)
    keep = (pos[None] <= pos[:, None]) & (pos[None] >= pos[:, None] - cfg["sliding_window"])
    for i in range(cfg["n_layers"]):
        w = layer_weights(p, i)
        h = rms_norm(x, w["attention_norm.weight"], eps)
        q, k, v = (lin(h, w[f"attention.w{c}.weight"], control).reshape(n, -1, hd) for c in "qkv")
        a = attention(rope(q, pos)[None], rope(k, pos)[None], v[None], keep[None, None])
        x = x + lin(a[0].reshape(n, d), w["attention.wo.weight"], control)
        h = rms_norm(x, w["ffn_norm.weight"], eps)
        u = (F.silu(lin(h, w["feed_forward.w1.weight"], control))
             * lin(h, w["feed_forward.w3.weight"], control))
        x = x + lin(u, w["feed_forward.w2.weight"], control)
    return lin(rms_norm(x, p["ar.norm.weight"], eps), p["ar.output.weight"], control)


def served_logits(prep, cfg, prompt, spk_codes, served):
    """(N, V) float32 logits that chose each of the N ``served`` tokens after
    ``prompt`` (P,), with the speaker of ``spk_codes`` (S, 8)."""
    p = prep["p"]
    x = torch.cat([spk_vector(p, spk_codes, cfg)[None], p["embed.weight"][prompt],
                   p["embed.weight"][served[:-1]]])
    run = mla_moe.logits if cfg.get("attention", "mha") == "mla" else mha_logits
    return run(p, cfg, x, prep["control"])[len(prompt):]
