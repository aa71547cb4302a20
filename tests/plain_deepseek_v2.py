"""A plain PyTorch reference of DeepSeek-V2's decoder block (HF
``modeling_deepseek.py``, V2) as the backbone of MARS5's codec LM.

It reads a ``CodecLM`` state dict (name -> float32 tensor) and the
configuration's fields as a dict (``dataclasses.asdict(CodecLMConfig)``),
and gives the full forward pass (the logits at every position), the mixture
of experts alone (``moe``, with its routing, ``route``) and the YaRN tables
(``yarn``). Float32, TF32 off, no cache, no kernels, no batching: plain
``torch`` only; nothing of the port or of JAX is imported.

    layer:  h = x + MLA(RMSNorm(x));  y = h + FFN(RMSNorm(h))
    MLA:    q = W_q x (H heads of nope + rope); [c ; k_pe] = W_kva x;
            c = RMSNorm_kv(c); [k_nope ; v] = W_kvb c (H heads of nope + v);
            q_pe, k_pe roped at YaRN's frequencies (k_pe shared by the heads);
            score = (q_nope . k_nope + q_pe . k_pe) * s, s = (nope + rope)^-0.5 m^2,
            m = 0.1 mscale_all_dim ln(factor) + 1; softmax in f32; W_o over H x v
    FFN:    dense SwiGLU below first_k_dense, else p = softmax(W_g x) over the E
            experts, the top k by p (not renormalised, times the scaling factor),
            y = sum_k p_k W2_k (silu(W1_k x) * W3_k x) + S(x)
    stack:  final RMSNorm, untied head; RMSNorm in f32 (eps norm_eps)

Departures from the published model (the port makes the same):

* Rope pairing: dims rotate in half-split pairs (i, i + rope/2). The
  checkpoint rotates interleaved pairs (2i, 2i + 1); the two are a row
  permutation of W_q's ``q_pe`` rows and W_kva's ``k_pe`` rows
  (``models/convert.mla_rope_rows``), which leaves every score as it is.
  The YaRN tables are computed in f64 and rounded to f32 once (HF computes
  them in f32).
* The speaker row: position 0 holds MARS5's speaker vector (its norm-first
  speaker encoder over the reference's codes, at the block's width and
  heads); the text ids and then the speech ids follow from position 1.
* The vocabulary layout: the stand-in tokenizers' text and speech ids are
  the first rows of the vocabulary; no other row is fed or sampled.
* The shared experts as one SwiGLU of n_shared x F, as HF's
  ``DeepseekV2MLP`` of that width runs them.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def yarn(cfg) -> dict:
    """YaRN over the rope dims (base 10000): ``low`` and ``high`` (the pairs the ramp
    runs between), ``inv_freq`` (rope/2,) f32, ``cos_scale`` (the factor on
    cos and sin) and ``scale`` (the scores')."""
    dim, base, factor = cfg["qk_rope_head_dim"], 10000.0, cfg["rope_factor"]
    original = cfg["rope_original_max_pos"]

    def pair(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    def mscale(m):
        return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0

    low = max(math.floor(pair(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(pair(cfg["rope_beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = base ** (-2 * i / dim)
    keep = 1 - ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    all_dim = cfg["rope_mscale_all_dim"]
    m = mscale(all_dim) if all_dim else 1.0
    return {"low": low, "high": high,
            "inv_freq": (extra / factor * (1 - keep) + extra * keep).float(),
            "cos_scale": mscale(cfg["rope_mscale"]) / mscale(all_dim),
            "scale": cfg["head_dim"] ** -0.5 * m * m}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps=4e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def rope(x, cos, sin):
    """x (L, H, d) rotated in (i, i + d/2) pairs by cos, sin (L, d/2)."""
    h = x.shape[-1] // 2
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x[..., :h] * c - x[..., h:] * s, x[..., :h] * s + x[..., h:] * c], dim=-1)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.t()) * (x @ w3.t())) @ w2.t()


def route(p, pre, cfg, x):
    """x (N, D) -> (probabilities (N, E), top-k weights (N, k), ids (N, k))."""
    probs = torch.softmax(x @ p[pre + "gate.weight"].t(), dim=-1)
    w, ids = torch.topk(probs, cfg["n_experts_per_tok"], dim=-1)
    return probs, w * cfg["routed_scaling_factor"], ids


def moe(p, pre, cfg, x):
    """The mixture of experts of ``pre`` (``ar.layers.<i>.feed_forward.``) over
    x (N, D): each expert over the tokens routed to it, weighted, summed, and
    the shared experts."""
    _, w, ids = route(p, pre, cfg, x)
    f = cfg["moe_hidden_dim"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if len(tok):
            w13, w2 = p[pre + "w13"][e], p[pre + "w2"][e]
            y[tok] += w[tok, slot, None] * swiglu(x[tok], w13[:f], w13[f:], w2)
    if cfg["n_shared_experts"]:
        s = pre + "shared."
        y = y + swiglu(x, p[s + "w1.weight"], p[s + "w3.weight"], p[s + "w2.weight"])
    return y


def mla(p, pre, cfg, h, cos, sin, keep):
    """Latent attention of ``pre`` (``ar.layers.<i>.attention.``) in the
    expanded form over normed h (N, D); keep (N, N) True where a key counts."""
    n, heads = h.shape[0], cfg["n_heads"]
    nope, rp, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (h @ p[pre + "wq.weight"].t()).reshape(n, heads, nope + rp)
    c, k_pe = (h @ p[pre + "wkv_a.weight"].t()).split([cfg["kv_lora_rank"], rp], dim=-1)
    c = rms_norm(c, p[pre + "kv_norm.weight"], cfg["norm_eps"])
    k_nope, v = (c @ p[pre + "wkv_b.weight"].t()).reshape(n, heads, nope + vd).split(
        [nope, vd], dim=-1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([k_nope, rope(k_pe[:, None], cos, sin).expand(n, heads, rp)], dim=-1)
    s = torch.einsum("qhd,khd->hqk", q, k) * yarn(cfg)["scale"]
    a = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", a, v).reshape(n, heads * vd) @ p[pre + "wo.weight"].t()


def backbone(p, cfg, x):
    """The decoder stack over x (N, D), embedded with the speaker row first:
    (N, V) logits at every position."""
    n = x.shape[0]
    t = yarn(cfg)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * t["inv_freq"].to(
        x.device)
    cos, sin = torch.cos(ang) * t["cos_scale"], torch.sin(ang) * t["cos_scale"]
    i = torch.arange(n, device=x.device)
    keep = (i[None] <= i[:, None]) & (i[None] >= i[:, None] - cfg["sliding_window"])
    eps = cfg["norm_eps"]
    for li in range(cfg["n_layers"]):
        pre = f"ar.layers.{li}."
        x = x + mla(p, pre + "attention.", cfg,
                    rms_norm(x, p[pre + "attention_norm.weight"], eps), cos, sin, keep)
        h = rms_norm(x, p[pre + "ffn_norm.weight"], eps)
        if cfg["n_routed_experts"] and li >= cfg["first_k_dense"]:
            x = x + moe(p, pre + "feed_forward.", cfg, h)
        else:
            f = pre + "feed_forward."
            x = x + swiglu(h, p[f + "w1.weight"], p[f + "w3.weight"], p[f + "w2.weight"])
    return rms_norm(x, p["ar.norm.weight"], eps) @ p["ar.output.weight"].t()


def speaker_vector(p, cfg, codes):
    """(S, n_codebooks) reference codes -> (D,): per-codebook lookups
    concatenated, the identity row first, sine positions, the key mask from
    the first pad code of codebook 0 on, the norm-first speaker encoder
    (LayerNorm eps 4e-5, SwiGLU FFN), row 0."""
    seq = torch.cat([p[f"ref_chunked_emb.embs.{i}.weight"][codes[:, i]]
                     for i in range(cfg["n_codebooks"])], dim=-1)
    x = torch.cat([p["spk_identity_emb.weight"], seq])
    n, d = x.shape
    pos = torch.arange(n, dtype=torch.float32, device=x.device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                    * -(math.log(10000.0) / d))
    x = x + p["pos_embedding.alpha"] * torch.stack(
        [torch.sin(pos * div), torch.cos(pos * div)], dim=-1).reshape(n, d)
    pad = torch.cumsum((codes[:, 0] == cfg["codebook_size"] - 1).int(), dim=0) > 0
    keep = ~torch.cat([torch.zeros(1, dtype=torch.bool, device=x.device), pad])
    heads = cfg["n_heads"]
    for li in range(cfg["n_spk_layers"]):
        pre = f"spk_encoder.layers.{li}."
        h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
        qkv = h @ p[pre + "self_attn.in_proj_weight"].t() + p[pre + "self_attn.in_proj_bias"]
        q, k, v = (t.reshape(n, heads, d // heads) for t in qkv.split(d, dim=-1))
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d // heads)
        a = torch.softmax(s.masked_fill(~keep[None, None], float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", a, v).reshape(n, d)
        x = x + o @ p[pre + "self_attn.out_proj.weight"].t() + p[pre + "self_attn.out_proj.bias"]
        h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
        u = F.silu(h @ p[pre + "activation.W.weight"].t()) * (h @ p[pre + "activation.V.weight"].t())
        x = x + u @ p[pre + "linear2.weight"].t() + p[pre + "linear2.bias"]
    return layer_norm(x, p["spk_encoder.norm.weight"], p["spk_encoder.norm.bias"])[0]


def forward(p, cfg, tokens, spk_codes):
    """The codec LM over ``tokens`` (L,) with the speaker of ``spk_codes``
    (S, n_codebooks) at position 0: (L + 1, V) logits, row i + 1 the logits
    after token i (row 0 after the speaker row)."""
    x = torch.cat([speaker_vector(p, cfg, spk_codes)[None], p["embed.weight"][tokens]])
    return backbone(p, cfg, x)
