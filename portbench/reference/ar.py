"""The AR codec language model, teacher-forced over a served request: the
building blocks every route's reference shares.

A Mistral decoder (RMSNorm, rotary positions, SwiGLU) over the joint text and
speech vocabulary, with a speaker vector from a two-layer norm-first encoder
over the reference codes at position 0 (the MARS5 release's ``CodecLM``).
The port prefills with the model as loaded (``prefill``) and decodes each
later token through its route's engine; ``decode_logits`` runs those steps
teacher-forced in one pass, with the route's weights and, where the route
quantizes them, its activations and cached K/V (``levels``). Each route's
module (``ar_<ar_backend>.py``) puts these together.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import quant
from .layers import attention, chunked, encoder, lin, rms_norm, rope, sine_pe


def spk_vector(p, codes, cfg):
    """(S, 8) reference codes -> (dim,) speaker vector (``CodecLM.spk_embedding``):
    chunked embed, the identity row prepended, sine positions, the key mask
    from the first pad code of codebook 0 on, the encoder, row 0."""
    seq = chunked(p, "ref_chunked_emb.", codes, cfg["n_codebooks"])
    seq = torch.cat([p["spk_identity_emb.weight"], seq], dim=0)
    seq = seq + p["pos_embedding.alpha"] * sine_pe(seq.shape[0], seq.shape[1], seq.device)
    pad = torch.cumsum((codes[:, 0] == cfg["codebook_size"] - 1).int(), dim=0) > 0
    pad = torch.cat([torch.zeros(1, dtype=torch.bool, device=pad.device), pad])
    out = encoder(p, "spk_encoder.", seq[None], cfg["n_spk_layers"], cfg["n_heads"], pad[None])
    return out[0, 0]


def layer_weights(p, i):
    """Layer i's weights and norms, by their names under ``ar.layers.i``."""
    pre = f"ar.layers.{i}."
    return {k: p[pre + k] for k in ("attention.wq.weight", "attention.wk.weight",
                                     "attention.wv.weight", "attention.wo.weight",
                                     "feed_forward.w1.weight", "feed_forward.w2.weight",
                                     "feed_forward.w3.weight", "attention_norm.weight",
                                     "ffn_norm.weight")}


def prefill(p, cfg, x):
    """The prompt's forward pass, x (P + 1, dim) embedded with the speaker row
    first: (logits of the last position (V,), per-layer (k, v), each (P + 1,
    H, hd), k roped)."""
    n, d, hd, eps = x.shape[0], cfg["dim"], cfg["head_dim"], cfg["norm_eps"]
    if n > cfg["sliding_window"]:
        raise ValueError("the reference covers prompts within the sliding window")
    pos = torch.arange(n, device=x.device)
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    kvs = []
    for i in range(cfg["n_layers"]):
        w = layer_weights(p, i)
        h = rms_norm(x, w["attention_norm.weight"], eps)
        q, k, v = (lin(h, w[f"attention.w{c}.weight"]).reshape(n, -1, hd) for c in "qkv")
        q, k = rope(q, pos), rope(k, pos)
        kvs.append((k, v))
        a = attention(q[None], k[None], v[None], causal[None, None])[0].reshape(n, d)
        x = x + lin(a, w["attention.wo.weight"])
        h = rms_norm(x, w["ffn_norm.weight"], eps)
        x = x + lin(F.silu(lin(h, w["feed_forward.w1.weight"]))
                    * lin(h, w["feed_forward.w3.weight"]), w["feed_forward.w2.weight"])
    logits = lin(rms_norm(x[-1:], p["ar.norm.weight"], eps), p["ar.output.weight"])
    return logits[0], kvs


def decode_logits(p, cfg, weights, head, kvs, tokens, start: int, levels):
    """The decode steps of ``tokens`` (N,) at positions start, start + 1, ...,
    teacher-forced in one pass: (N, V) logits. ``levels``: the levels of
    the quantized quantities (each GEMM's input rows, the cached K/V per
    position; the current token's own K/V stays unquantized, as the step
    computes it), or None where the route quantizes none."""
    n, d, hd, eps = tokens.shape[0], cfg["dim"], cfg["head_dim"], cfg["norm_eps"]
    dev = tokens.device
    x = p["embed.weight"][tokens]
    pos = torch.arange(start, start + n, device=dev)
    npre = kvs[0][0].shape[0]
    # query i sees every prompt slot and the decode slots before it (cached)
    # and itself (unquantized, as the step computes it)
    keep = torch.cat([torch.ones(n, npre, dtype=torch.bool, device=dev),
                      torch.ones(n, n, dtype=torch.bool, device=dev).tril()], dim=1)

    def kvq(t):
        if levels is None:
            return t
        return quant.act(t.reshape(t.shape[0], -1), levels).reshape(t.shape)

    for i, w in enumerate(weights):
        h = rms_norm(x, w["attention_norm.weight"], eps)
        q, k, v = (lin(h, w[f"attention.w{c}.weight"], levels=levels).reshape(n, -1, hd)
                   for c in "qkv")
        q, k = rope(q, pos), rope(k, pos)
        kp, vp = kvs[i]
        keys = torch.cat([kvq(kp), kvq(k)])
        vals = torch.cat([kvq(vp), kvq(v)])
        s = torch.einsum("qhd,khd->hqk", q, keys) / hd ** 0.5
        idx = torch.arange(n, device=dev)
        s[:, idx, npre + idx] = torch.einsum("qhd,qhd->hq", q, k) / hd ** 0.5
        s = s.masked_fill(~keep[None], float("-inf"))
        pr = torch.softmax(s, dim=-1)
        self_p = pr[:, idx, npre + idx].clone()
        pr[:, idx, npre + idx] = 0.0
        a = torch.einsum("hqk,khd->qhd", pr, vals) + self_p.t()[..., None] * v
        x = x + lin(a.reshape(n, d), w["attention.wo.weight"], levels=levels)
        h = rms_norm(x, w["ffn_norm.weight"], eps)
        u = (F.silu(lin(h, w["feed_forward.w1.weight"], levels=levels))
             * lin(h, w["feed_forward.w3.weight"], levels=levels))
        x = x + lin(u, w["feed_forward.w2.weight"], levels=levels)
    return lin(rms_norm(x, p["ar.norm.weight"], eps), head)
