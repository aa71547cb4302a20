"""The DeepSeek-V2 decoder block as the codec LM's backbone, teacher-forced over
a served request: the benchmark's copy of the plain reference
``tests/plain_deepseek_v2.py`` (HF ``modeling_deepseek.py``, V2).

    layer:  h = x + MLA(RMSNorm(x));  y = h + FFN(RMSNorm(h))
    MLA:    q = W_q x (H heads of nope + rope); [c ; k_pe] = W_kva x;
            c = RMSNorm_kv(c); [k_nope ; v] = W_kvb c (H heads of nope + v);
            q_pe, k_pe roped at YaRN's frequencies (k_pe shared by the heads);
            score = (q_nope . k_nope + q_pe . k_pe) * s, s = (nope + rope)^-0.5 m^2,
            m = 0.1 mscale_all_dim ln(factor) + 1; softmax; W_o over H x v
    FFN:    a dense SwiGLU below first_k_dense, else p = softmax(W_g x) over
            the E experts, the top k by p (not renormalised, times the
            scaling factor), y = sum_k p_k W2_k (silu(W1_k x) * W3_k x) + S(x)
    stack:  final RMSNorm, untied head

Departures from the published model, as the port makes them: the rope dims
rotate in half-split pairs (a row permutation of the checkpoint's
interleaved ``q_pe`` and ``k_pe`` rows, which leaves scores as they are;
the YaRN tables in f64, rounded once); position 0 holds MARS5's speaker
vector (``ar.spk_vector``), the text ids and then the speech ids follow;
the stand-in tokenizers' ids are the vocabulary's first rows; the shared
experts run as one SwiGLU of n_shared x F.

``lin`` is every GEMM of the stack and the head: with ``control`` both of
its operands are first rounded to float8 e4m3 with a scale a row (the
largest magnitude of each row of x, and of each output row of the weight,
to 448), the precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .layers import rms_norm

FP8_MAX = 448.0


def fp8_rows(t):
    """``t`` rounded to float8 e4m3 with one scale a row, back in float32."""
    s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def lin(x, w, control: bool = False):
    if control:
        x, w = fp8_rows(x), fp8_rows(w)
    return x @ w.t()


def yarn(cfg) -> dict:
    """YaRN at base 10000: ``inv_freq`` (rope/2,) f32, ``cos_scale`` and the
    scores' ``scale``."""
    dim, base, factor = cfg["qk_rope_head_dim"], 10000.0, cfg["rope_factor"]

    def pair(rotations):
        return (dim * math.log(cfg["rope_original_max_pos"] / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    def mscale(m):
        return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0

    low = max(math.floor(pair(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(pair(cfg["rope_beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = base ** (-2 * i / dim)
    keep = 1 - ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    all_dim = cfg["rope_mscale_all_dim"]
    m = mscale(all_dim) if all_dim else 1.0
    return {"inv_freq": (extra / factor * (1 - keep) + extra * keep).float(),
            "cos_scale": mscale(cfg["rope_mscale"]) / mscale(all_dim),
            "scale": cfg["head_dim"] ** -0.5 * m * m}


def rope(x, cos, sin):
    """x (L, H, d) rotated in (i, i + d/2) pairs by cos, sin (L, d/2)."""
    h = x.shape[-1] // 2
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x[..., :h] * c - x[..., h:] * s, x[..., :h] * s + x[..., h:] * c], dim=-1)


def swiglu(x, w1, w3, w2, control):
    return lin(F.silu(lin(x, w1, control)) * lin(x, w3, control), w2, control)


def moe(p, pre, cfg, x, control=False):
    """The mixture of experts under ``pre`` over x (N, D): each expert over the
    tokens routed to it, weighted, summed, then the shared experts."""
    probs = torch.softmax(lin(x, p[pre + "gate.weight"], control), dim=-1)
    w, ids = torch.topk(probs, cfg["n_experts_per_tok"], dim=-1)
    w = w * cfg["routed_scaling_factor"]
    f = cfg["moe_hidden_dim"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if len(tok):
            w13 = p[pre + "w13"][e]
            y[tok] += w[tok, slot, None] * swiglu(x[tok], w13[:f], w13[f:], p[pre + "w2"][e],
                                                  control)
    if cfg["n_shared_experts"]:
        s = pre + "shared."
        y = y + swiglu(x, p[s + "w1.weight"], p[s + "w3.weight"], p[s + "w2.weight"], control)
    return y


def mla(p, pre, cfg, h, cos, sin, control=False):
    """Latent attention under ``pre`` in the expanded form over normed h
    (N, D), causal."""
    n, heads = h.shape[0], cfg["n_heads"]
    nope, rp, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = lin(h, p[pre + "wq.weight"], control).reshape(n, heads, nope + rp)
    c, k_pe = lin(h, p[pre + "wkv_a.weight"], control).split([cfg["kv_lora_rank"], rp], dim=-1)
    c = rms_norm(c, p[pre + "kv_norm.weight"], cfg["norm_eps"])
    k_nope, v = lin(c, p[pre + "wkv_b.weight"], control).reshape(n, heads, nope + vd).split(
        [nope, vd], dim=-1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([k_nope, rope(k_pe[:, None], cos, sin).expand(n, heads, rp)], dim=-1)
    s = torch.einsum("qhd,khd->hqk", q, k) * yarn(cfg)["scale"]
    i = torch.arange(n, device=h.device)
    keep = (i[None] <= i[:, None]) & (i[None] >= i[:, None] - cfg["sliding_window"])
    a = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", a, v).reshape(n, heads * vd)
    return lin(o, p[pre + "wo.weight"], control)


def logits(p, cfg, x, control=False):
    """The decoder stack over x (N, D), embedded with the speaker row first:
    the (N, V) logits at every position."""
    n = x.shape[0]
    t = yarn(cfg)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * t["inv_freq"].to(
        x.device)
    cos, sin = torch.cos(ang) * t["cos_scale"], torch.sin(ang) * t["cos_scale"]
    eps = cfg["norm_eps"]
    for li in range(cfg["n_layers"]):
        pre = f"ar.layers.{li}."
        x = x + mla(p, pre + "attention.", cfg,
                    rms_norm(x, p[pre + "attention_norm.weight"], eps), cos, sin, control)
        h = rms_norm(x, p[pre + "ffn_norm.weight"], eps)
        f = pre + "feed_forward."
        if cfg["n_routed_experts"] and li >= cfg["first_k_dense"]:
            x = x + moe(p, f, cfg, h, control)
        else:
            x = x + swiglu(h, p[f + "w1.weight"], p[f + "w3.weight"], p[f + "w2.weight"],
                           control)
    return lin(rms_norm(x, p["ar.norm.weight"], eps), p["ar.output.weight"], control)
