"""The model FLOPs a finished request needed (a multiply-add counts two),
counted from its shapes: the work of the function, not of the program's
implementation. Per row of a call:

* AR: the speaker encoder over the reference's frames, the prompt's forward
  pass (causal attention) with the head at its last position, then each
  later generated token's step over its cache and the whole head;
* NAR: the speaker encoder and, for each of the T reverse steps, the
  encoder memory and the decoder over the row's frames, with the
  unconditional rows on the steps the guidance interval gives CFG, and the
  seven heads over the generated frames.

The codecs are not counted (under 1% of a request's FLOPs at these widths).
"""

from __future__ import annotations

import numpy as np

from .reference.diffusion import guided as cfg_step


def _enc(tokens, d, f, layers):
    """A norm-first SwiGLU encoder stack over ``tokens`` tokens."""
    return layers * (2 * tokens * (4 * d * d + 3 * d * f) + 4 * tokens * tokens * d)


def ar_flops(cfg, prompt_len: int, n_gen: int, spk_frames: int) -> float:
    d, f, L, V = cfg["dim"], cfg["hidden_dim"], cfg["n_layers"], cfg["n_vocab"]
    e = L * (4 * d * d + 3 * d * f)
    n = prompt_len + 1
    total = _enc(spk_frames + 1, d, cfg["spk_hidden_dim"], cfg["n_spk_layers"])
    total += 2 * e * n + 2 * L * d * n * (n + 1) + 2 * d * V
    for k in range(1, n_gen):
        total += 2 * e + 4 * L * d * (n + k) + 2 * d * V
    return float(total)


def nar_flops(cfg, frames: int, gen: int, text: int, spk_frames: int, T: int,
              cfg_steps: int, guided: bool) -> float:
    """One row of ``frames`` decoder frames (``gen`` of them generated),
    ``text`` encoder tokens (the speaker row included) and ``spk_frames``
    reference frames, over ``T`` steps of which ``cfg_steps`` run CFG."""
    d, f, K = cfg["dim"], cfg["hidden_dim"], cfg["n_quant"]
    lanes = cfg["pred_quant_levels"] - 1
    dec = cfg["dec_layers"] * (2 * frames * (6 * d * d + 3 * d * f) + 2 * text * 2 * d * d
                               + 4 * frames * frames * d + 4 * frames * text * d)
    per_row = _enc(text, d, f, cfg["enc_layers"]) + dec + 2 * gen * lanes * K * d
    rows = T + (cfg_steps if guided else 0)
    spk = _enc(spk_frames + 1, d, f, cfg["n_spk_layers"]) * (2 if guided else 1)
    return float(spk + rows * per_row)


def request_flops(rec, cfg) -> float:
    """The FLOPs of one finished call (all its rows)."""
    total = 0.0
    for i, (seq, n_gen) in enumerate(rec["ar"] or ()):
        codes = rec["codes"][i if len(rec["codes"]) > 1 else 0]
        total += ar_flops(cfg["ar"], len(seq) - n_gen, n_gen, int(codes.shape[-1]))
    nar = rec["nar"]
    if nar is None:
        return total
    c_text, c_codes, ctl, ccl, x, xpm = nar["batch"]
    T = rec["request"].timesteps
    interval = cfg["options"].get("guidance_interval", (0.0, 1.0))
    cfg_steps = sum(1 for t in range(T) if cfg_step(t, T, interval))
    w_guided = cfg["inference"]["nar_guidance_w"] != 1
    xpm = np.asarray(xpm)
    for r in range(xpm.shape[0]):
        gen = int((~xpm[r]).sum())
        prompt = int(np.asarray(ccl)[r]) if rec["request"].deep_clone else 0
        total += nar_flops(cfg["nar"], prompt + gen, gen, int(np.asarray(ctl)[r]) + 1,
                           int(np.asarray(ccl)[r]), T, cfg_steps, w_guided)
    return total
