"""The NAR multinomial-diffusion denoiser and one reverse step of it: the
building blocks every route's reference shares.

An encoder-decoder transformer (the MARS5 release's ``ResidualTransformer``):
the encoder reads [speaker vector] ++ text with sine positions plus a
timestep MLP; the decoder reads the chunked embedding of x_t with sine
positions plus a second timestep MLP and attends across to the encoder's
memory; seven heads predict x_0 for lanes 1..7. One reverse step combines
the conditional and unconditional rows (CFG weight w) on the steps the
guidance interval gives CFG, tempers, forms the posterior over x_{t-1} and
draws by Gumbel-max. Each route's module (``nar_<nar_backend>.py``) gives
the weights as the route holds them, its heads and its levels.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .layers import chunked, decoder_layer, encoder, layer_norm, lin, sine_pe

def _length_mask(lengths, width):
    """True at and past each row's length."""
    return torch.arange(width, device=lengths.device)[None] >= lengths[:, None]


def speaker(p, cfg, codes, ccl):
    """(R, S, 8) codes and (R,) lengths -> (R, dim) speaker vectors."""
    seq = chunked(p, "ref_embedder.", codes, cfg["c_quant_levels"])
    ident = p["spk_identity_emb.weight"][None].expand(seq.shape[0], 1, -1)
    seq = torch.cat([ident, seq], dim=1)
    seq = seq + p["ref_pos_embedding.alpha"] * sine_pe(seq.shape[1], seq.shape[2], seq.device)
    pad = _length_mask(ccl + 1, seq.shape[1])
    return encoder(p, "spk_encoder.", seq, cfg["n_spk_layers"], cfg["nhead"], pad)[:, 0]


def timestep(p, pre, t: int, cfg, device):
    """The ``pre`` timestep MLP of step t: (dim,)."""
    half = cfg["t_emb_dim"] // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=device) / half)
    e = torch.cat([torch.cos(t * freqs), torch.sin(t * freqs)])
    return lin(F.silu(lin(e, p[pre + "0.weight"], p[pre + "0.bias"])), p[pre + "2.weight"],
               p[pre + "2.bias"])


def memory(p, cfg, c_text, ctl, c_codes, ccl, t: int, cfg_rows: bool, levels):
    """The encoder memory of step t and its padding: the conditional rows,
    then with ``cfg_rows`` the unconditional ones (speaker codes dropped)."""
    bs = c_text.shape[0]
    if cfg_rows:
        drop = torch.arange(2 * bs, device=c_text.device) >= bs
        ccl = torch.where(drop, 0, ccl.repeat(2))
        c_codes = torch.where(drop[:, None, None], cfg["n_quant"] - 1, c_codes.repeat(2, 1, 1))
        c_text, ctl = c_text.repeat(2, 1), ctl.repeat(2)
    spk = speaker(p, cfg, c_codes, ccl)
    c = torch.cat([spk[:, None], p["text_embed.weight"][c_text]], dim=1)
    c = c + p["cond_pos_embedding.alpha"] * sine_pe(c.shape[1], c.shape[2], c.device)
    pad = _length_mask(ctl + 1, c.shape[1])
    c = c + timestep(p, "timestep_encoder_emb.", t, cfg, c.device)
    return encoder(p, "tfm.encoder.", c, cfg["enc_layers"], cfg["nhead"], pad, levels), pad


def decoder(p, cfg, x, xpm, t: int, mem, mem_pad, levels):
    """The decoder over x (R, L, 8) with padding xpm (R, L): (R, L, dim)."""
    h = chunked(p, "residual_encoder.", x, cfg["c_quant_levels"])
    h = h + p["pos_embedding.alpha"] * sine_pe(h.shape[1], h.shape[2], h.device)
    h = h + timestep(p, "timestep_decoder_emb.", t, cfg, h.device)
    for i in range(cfg["dec_layers"]):
        h = decoder_layer(p, f"tfm.decoder.layers.{i}.", h, mem, cfg["nhead"], xpm, mem_pad,
                          levels)
    return layer_norm(h, p["tfm.decoder.norm.weight"], p["tfm.decoder.norm.bias"])


def scores(logits, bs, guided: bool, w, temp, x_t, tables, t: int, u0):
    """The reverse step's per-class scores (bs, L, 7, K), whose argmax is the
    draw: on a guided step the CFG combine of the conditional and
    unconditional rows, the tempered log-softmax, the posterior at t,
    Gumbel noise from the step's uniforms ``u0``
    (``mars5_tts_torch/ops/kernels/diffusion_tail.py:155-173``)."""
    z = w * logits[:bs] + (1.0 - w) * logits[bs:] if guided else logits
    log_x0 = torch.log_softmax(z / temp, dim=-1)
    a, b1, hot, cold = tables.scalars(t)
    lev = log_x0 if t == 0 else torch.logaddexp(log_x0 + a, torch.full_like(log_x0, b1))
    col = torch.arange(z.shape[-1], device=z.device)
    un = lev + torch.where(col == x_t[..., None], hot, cold)
    g = -torch.log(torch.clamp(-torch.log(torch.clamp(u0, min=1e-7)), min=1e-7))
    return un + g


def step_scores(q, cfg, step, batch, tables, heads, levels, s):
    """The scores of one recorded reverse step (see ``portbench/record.py``):
    the encoder memory and the decoder over the step's own x_t, ``heads``
    (the route's: decoder output -> (R, L, 7, K) logits), the tail. ``s``:
    what the request states for the step: ``guided`` (CFG on this step),
    ``batched`` (the memory holds the unconditional rows, w != 1), ``w``
    and ``temp``."""
    c_text, ctl, c_codes, ccl = batch["c_text"], batch["ctl"], batch["c_codes"], batch["ccl"]
    bs = c_text.shape[0]
    mem, mem_pad = memory(q, cfg, c_text, ctl, c_codes, ccl, step["t"], s["batched"], levels)
    if not s["guided"]:
        mem, mem_pad = mem[:bs], mem_pad[:bs]
    x, xpm = step["x"], step["xpm"]
    if s["guided"]:
        x, xpm = x.repeat(2, 1, 1), xpm.repeat(2, 1)
    out = decoder(q, cfg, x, xpm, step["t"], mem, mem_pad, levels)[:, step["offset"]:]
    return scores(heads(q, out), bs, s["guided"], s["w"], s["temp"], step["x_t"], tables,
                  step["t"], step["u0"])
