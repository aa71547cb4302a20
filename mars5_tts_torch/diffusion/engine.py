"""NAR diffusion inference: RePaint inpainting over the 8-codebook grid
(counterpart of ``mars5_tts_tpu/diffusion/engine.py``).

Each reverse step predicts x0 logits for the generated frames (lanes 1..7),
combines cond and uncond rows with classifier-free guidance (both run as one
batch of 2B rows), tempers, forms the posterior and draws by Gumbel-max; the
known region (the deep-clone prompt frames and the AR-pinned L0 lane) is
re-noised from ``x_known`` and taken verbatim at t = 0. Forward (re-noise)
steps appear only when RePaint resampling is on. L0 is re-pinned to the AR
codes while ``t > q0_override_steps``.

Deep clone puts each row's prompt frames ahead of its generated frames.
When every row has the same prompt length (the static-offset path) the
model's heads, the posterior and the draws cover the generated frames only.
Rows with different prompt lengths (the ragged path, several voices in one
batch) are laid out ``[prompt_r; gen; pad]`` at their solo positions; the
model and the known-region draws then cover the whole grid, composited with
a ``position < prompt_r`` mask, and each row is cropped at its own offset,
so a row's result is that of its solo run.

Randomness is either an injected ``uniforms`` stream of shape
``(n_steps, 2, bs, L, 8, K)`` (index 0: unknown region, 1: known region;
dense math, for cross-package parity) or per-step draws from a
``torch.Generator`` on the model's device, with the two-uniform samplers for
known-region and forward draws and an unnormalized posterior (Gumbel-max is
shift-invariant), as the JAX key path does.

A W8A8 model (``ops/quant.quantize_nar``) takes the serving route: folded
quantized heads (``fold_quant_heads``) and, on the generator path, one of
three tails that draw on the same uniforms:

* ``"heads"``: kernel K6 (``heads_diffusion_tail``) fuses the heads GEMM,
  CFG, posterior and Gumbel-max (the JAX default);
* ``"split"``: the folded heads (``nar_heads_folded``), then kernel K5
  (``diffusion_tail``) on their bf16 logits (JAX ``MARS5_FUSED_HEADTAIL=0``);
* ``"dense"``: the folded heads and the dense PyTorch tail (JAX
  ``MARS5_FUSED_TAIL=0``).

The injected uniform path keeps the dense tail, as the JAX package does.
``mega``, the stack's ``build_mega_pack``, runs the W8A8 decoder stack
through kernel K9 (JAX ``MARS5_NAR_MEGA=1``).

``DSH.guidance_interval = (lo, hi)`` keeps CFG to the reverse steps with
``round(lo T) <= t < round(hi T)``; the others run the conditional rows
alone (the cond halves of the CFG-batched encoder memory and padding, the
tails with ``rows == bs``, which take w = 1). ``gen_bucket`` /
``text_bucket`` pad the generated-frame and text axes up to multiples of
the bucket (masked frames and tokens, cropped after), so under injected
uniforms the real-frame grid is that of the exact shapes. With
``honor_last_greedy`` and ``DSH.last_greedy`` the step at t = 0 takes the
argmax of the posterior (the reference documents it but never passes it,
so the default keeps sampling there, as the JAX package does).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import DSH
from ..models.layers import DEFAULT_OPTIONS, NarOptions
from ..models.nar import (ResidualTransformer, fold_quant_heads, nar_heads_folded,
                          nar_heads_prequant)
from ..ops.kernels.diffusion_tail import diffusion_tail, heads_diffusion_tail, tail_scalars
from ..ops.kernels.nar_mega import MegaPack
from .multinomial import MultinomialDiffusion, log_sample_categorical
from .schedule import build_step_plan


TAILS = ("heads", "split", "dense")


def _as(x, dtype, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


@torch.inference_mode()
def perform_simple_inference(model: ResidualTransformer, batch,
                             diff: MultinomialDiffusion, T: int, dsh: DSH = DSH(),
                             retain_quant0: bool = True,
                             generator: torch.Generator | None = None,
                             uniforms=None, x_init=None, tail: str = "heads",
                             mega: MegaPack | None = None,
                             options: NarOptions = DEFAULT_OPTIONS,
                             gen_bucket: int = 0, text_bucket: int = 0,
                             honor_last_greedy: bool = False, batch_rows: tuple | None = None):
    """Run the whole inpainting trajectory.

    batch: (c_text (bs, Lt), c_codes (bs, Lc, 8), c_texts_length (bs,),
    c_codes_length (bs,), x (bs, Lx, 8) with L0 = AR codes,
    x_padding_mask (bs, Lx)), numpy arrays or tensors.
    Returns the (bs, Lx, 8) int64 grid on the model's device, deep-clone
    prompt frames cropped (each row at its own prompt length). ``tail`` ("heads", "split" or "dense") picks a
    W8A8 model's tail on the generator path and ``mega`` (a ``MegaPack``)
    its decoder stack route, as in the module docstring; ``options``
    (``models.layers.NarOptions``) the encoder's and decoder's routes.
    ``gen_bucket`` / ``text_bucket`` (0: exact shapes) and
    ``honor_last_greedy``: as in the module docstring; ``uniforms`` span the
    unpadded ``L_total`` (the padded frames draw 0.5). ``batch_rows`` (lo,
    hi): run rows [lo, hi) of ``batch`` alone, as they run in the whole
    batch's trajectory (a data-parallel shard, ``serving/multichip.py``):
    the layout (a ragged batch's width), ``uniforms`` and ``x_init`` are the
    whole batch's, and the generator draws at the whole batch's shape, each
    cut to these rows; returns their (hi - lo, Lx, 8) grid.
    """
    if tail not in TAILS:
        raise ValueError(f"unknown tail {tail!r}; expected one of {TAILS}")
    if mega is not None and not model.is_quantized:
        raise ValueError("mega needs a W8A8 model")
    dev = model.text_embed.weight.device
    c_text, c_codes, ctl, ccl, x, xpm = batch
    c_text, c_codes, ctl, ccl, x = (_as(v, torch.long, dev)
                                    for v in (c_text, c_codes, ctl, ccl, x))
    xpm = _as(xpm, torch.bool, dev)
    lx_real = x.shape[1]
    if gen_bucket > 1 and lx_real % gen_bucket:
        # generated frames sit at the end of L_total in every row layout, so
        # the padding only appends positions, masked and cropped after
        pad = gen_bucket - lx_real % gen_bucket
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        xpm = torch.nn.functional.pad(xpm, (0, pad), value=True)
        if x_init is not None:
            x_init = torch.nn.functional.pad(_as(x_init, torch.long, dev), (0, 0, 0, pad))
        if uniforms is not None:
            uniforms = np.pad(np.asarray(uniforms, np.float32),
                              ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0), (0, 0)),
                              constant_values=0.5)
    if text_bucket > 1 and c_text.shape[1] % text_bucket:
        # the padded tokens are masked by c_texts_length
        c_text = torch.nn.functional.pad(c_text, (0, text_bucket - c_text.shape[1] % text_bucket))
    bs, lx = x.shape[:2]
    offset = 0
    offsets = None                  # (bs,) prompt lengths of a ragged batch
    if dsh.deep_clone:
        lengths = ccl.tolist()
        if len(set(lengths)) > 1:
            offsets, width = lengths, max(lengths)
        else:
            offset = lengths[0]
            if c_codes.shape[1] != offset:
                raise ValueError("deep clone needs unpadded c_codes")

    use_key = uniforms is None
    if use_key and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if x_init is None:
        x_init = torch.randint(0, diff.num_classes, x.shape, generator=generator,
                               device=dev)
    else:
        x_init = _as(x_init, torch.long, dev)
    draw_rows = None
    if batch_rows is not None:      # a shard: these rows of the whole batch
        rows = slice(*batch_rows)
        draw_rows = (*batch_rows, bs)
        c_text, c_codes, ctl, ccl, x, xpm, x_init = (
            v[rows] for v in (c_text, c_codes, ctl, ccl, x, xpm, x_init))
        if uniforms is not None:
            uniforms = np.asarray(uniforms)[:, :, rows]
        offsets = None if offsets is None else offsets[rows]
        bs = x.shape[0]
    x_quant0 = x[..., 0]
    x_cur = x_init.clone()
    x_cur[..., 0] = x_quant0
    x_known = torch.zeros_like(x_cur)
    x_known[..., 0] = x_quant0
    if offset:
        x_cur = torch.cat([c_codes, x_cur], dim=1)
        x_known = torch.cat([c_codes, x_known], dim=1)
        xpm = torch.cat([torch.zeros((bs, offset), dtype=torch.bool, device=dev), xpm],
                        dim=-1)
        x_quant0 = torch.cat([c_codes[..., 0], x_quant0], dim=-1)
    elif offsets is not None:       # [prompt_r; gen; pad] per row
        length = width + lx
        grids = [torch.zeros((bs, length, x.shape[2]), dtype=torch.long, device=dev)
                 for _ in range(2)]
        pad = torch.ones((bs, length), dtype=torch.bool, device=dev)
        for r, lc in enumerate(offsets):
            for g, src in zip(grids, (x_cur, x_known)):
                g[r, :lc] = c_codes[r, :lc]
                g[r, lc:lc + lx] = src[r]
            pad[r, :lc] = False
            pad[r, lc:lc + lx] = xpm[r]
        x_cur, x_known = grids
        xpm = pad
        x_quant0 = x_cur[..., 0].clone()
    if not use_key:
        uniforms = torch.as_tensor(np.asarray(uniforms, np.float32), device=dev)

    t_lasts, is_reverse, cs = build_step_plan(T, dsh.jump_len, dsh.jump_n_sample)
    out = _trajectory(model, dsh, diff, c_text, c_codes, ctl, ccl, x_cur, x_known,
                      xpm, x_quant0, t_lasts, is_reverse, cs, uniforms, generator,
                      offset, retain_quant0, tail, mega, offsets, options,
                      honor_last_greedy and dsh.last_greedy, draw_rows)
    if offsets is not None:         # each row's generated frames at its own offset
        return torch.stack([out[r, lc:lc + lx_real] for r, lc in enumerate(offsets)])
    return out[:, offset:offset + lx_real]


def _cfg_steps(dsh: DSH, T: int):
    """The guidance interval as a function of t: True where a reverse step
    keeps CFG (``round(lo T) <= t < round(hi T)`` of
    ``dsh.guidance_interval``; every t for (0, 1)). With w = 1 no step runs
    uncond rows whatever it says."""
    gi = tuple(getattr(dsh, "guidance_interval", (0.0, 1.0)))
    if gi == (0.0, 1.0):
        return lambda t: True
    lo_t, hi_t = int(round(gi[0] * T)), int(round(gi[1] * T))
    return lambda t: lo_t <= t < hi_t


def _progress(i: int, n: int) -> None:
    """The stderr line of ``DSH.progress`` every 10 steps and at the last."""
    i += 1
    if i % 10 == 0 or i == n:
        print(f"\rdiffusion step {i}/{n}", end="" if i < n else "\n", file=sys.stderr,
              flush=True)


def _trajectory(model, dsh, diff, c_text, c_codes, ctl, ccl, x, x_known, xpm,
                x_quant0, t_lasts, is_reverse, cs, uniforms, generator, offset,
                retain_quant0, tail, mega, offsets=None, options=DEFAULT_OPTIONS,
                greedy_t0=False, draw_rows=None):
    dev = x.device
    bs, _, n_lanes = x.shape
    K = diff.num_classes
    T = diff.num_timesteps
    l_gen = x.shape[1] - offset
    use_key = uniforms is None
    w = dsh.guidance_w
    cfg_batched = w != 1
    use_cfg = _cfg_steps(dsh, T)
    if offsets is not None:         # the known region of a ragged batch, (bs, L, 1)
        known_mask = (torch.arange(x.shape[1], device=dev)[None]
                      < torch.as_tensor(offsets, device=dev)[:, None])[..., None]

    # loop invariants: the speaker vector once per CFG row, and the encoder
    # memory of every timestep in one batched forward (the encoder depends on
    # t only through the additive t_enc embedding)
    if cfg_batched:
        drop = torch.cat([torch.zeros(bs, dtype=torch.bool, device=dev),
                          torch.ones(bs, dtype=torch.bool, device=dev)])
        ccl_d = torch.where(drop, 0, ccl.repeat(2))
        codes_d = torch.where(drop[:, None, None], K - 1, c_codes.repeat(2, 1, 1))
        spk = model.spk_embedding(codes_d, ccl_d, options)
        c_base, c_padding = model.enc_inputs(c_text.repeat(2, 1), ctl.repeat(2), spk)
        xpm_rows = xpm.repeat(2, 1)
    else:
        spk = model.spk_embedding(c_codes, ccl, options)
        c_base, c_padding = model.enc_inputs(c_text, ctl, spk)
        xpm_rows = xpm
    rows, lc, dim = c_base.shape
    t_enc_all, t_dec_all = model.timestep_mlps(torch.arange(T, device=dev), c_base.dtype)
    c_all = (c_base[None] + t_enc_all[:, None, None]).reshape(T * rows, lc, dim)
    cp_all = c_padding[None].expand(T, rows, lc).reshape(T * rows, lc)
    memory_all = model.tfm.encoder(c_all, key_padding_mask=cp_all,
                                   options=options).reshape(T, rows, lc, dim)

    # W8A8: the heads' LN affines folded into requantized head weights
    folded = fold_quant_heads(model, tuple(range(1, n_lanes))) if model.is_quantized else None
    kernel_tail = tail if folded is not None and use_key else "dense"

    def decoder_out(x, t_last, with_cfg):
        """Decoder output on the generated frames: (rows, l_gen, dim), or
        (bs, l_gen, dim) of the cond rows alone on a step without CFG."""
        if cfg_batched and with_cfg:
            return model.decoder_apply(torch.cat([x, x]), xpm_rows,
                                       t_dec_all[t_last][None].expand(rows, dim),
                                       memory_all[t_last], c_padding, q_tail_start=offset,
                                       mega=mega, options=options)
        # a cond-only step: the cond halves of the CFG-batched memory and padding
        # (contiguous leading rows, as the kernels read them)
        return model.decoder_apply(x, xpm, t_dec_all[t_last][None].expand(bs, dim),
                                   memory_all[t_last][:bs], c_padding[:bs],
                                   q_tail_start=offset, mega=mega, options=options)

    def x0_logits(x, t_last, with_cfg):
        """CFG-combined f32 x0 logits on the generated frames, lanes 1.."""
        out = decoder_out(x, t_last, with_cfg)
        logits = (nar_heads_folded(folded, out) if folded is not None
                  else model.heads(out, lanes=range(1, n_lanes))).float()
        if cfg_batched and with_cfg:
            return w * logits[:bs] + (1.0 - w) * logits[bs:]
        return logits

    def rand(*shape):
        if draw_rows is None:
            return torch.rand(shape, generator=generator, device=dev)
        lo, hi, n = draw_rows       # the whole batch's draw, cut to a shard's rows
        return torch.rand((n, *shape[1:]), generator=generator, device=dev)[lo:hi]

    def reverse(x, i, t):
        with_cfg = use_cfg(t)
        greedy = greedy_t0 and t == 0
        if kernel_tail == "heads":
            x8, xs = nar_heads_prequant(decoder_out(x, t, with_cfg))
            unknown = heads_diffusion_tail(
                x8, xs, folded, rand(bs, l_gen, n_lanes - 1, K), x[:, offset:, 1:],
                tail_scalars(diff, t, use_gumbel=not greedy), w=w, temp=dsh.x_0_temp)
        elif kernel_tail == "split":
            unknown = diffusion_tail(
                nar_heads_folded(folded, decoder_out(x, t, with_cfg)),
                rand(bs, l_gen, n_lanes - 1, K), x[:, offset:, 1:],
                tail_scalars(diff, t, use_gumbel=not greedy), w=w, temp=dsh.x_0_temp)
        else:
            log_x0 = torch.log_softmax(x0_logits(x, t, with_cfg) / dsh.x_0_temp, dim=-1)
            log_pred = diff.q_posterior_indexed(log_x0, x[:, offset:, 1:], t,
                                                normalize=not use_key)
            # the reference never forwards last_greedy to its reverse step, so
            # t = 0 samples too unless honor_last_greedy asks otherwise
            unknown = log_sample_categorical(
                log_pred, rand(*log_pred.shape) if use_key else uniforms[i, 0][:, offset:, 1:])
            if greedy:
                unknown = torch.argmax(log_pred, dim=-1)
        if offsets is not None:     # known draws over the whole grid, composited
            if use_key:
                known = diff.q_pred_indexed_sample(x_known, t, rand(*x.shape, 2))
            else:
                known = log_sample_categorical(diff.q_pred_indexed(x_known, t), uniforms[i, 1])
            if t == 0:
                known = x_known
            rest = torch.where(known_mask, known[..., 1:], unknown)
            return torch.cat([known[..., :1], rest], dim=2)
        if use_key:
            kp = diff.q_pred_indexed_sample(x_known[:, :offset], t,
                                            rand(bs, offset, n_lanes, 2))
            kl = diff.q_pred_indexed_sample(x_known[:, offset:, :1], t,
                                            rand(bs, l_gen, 1, 2))
        else:
            kp = log_sample_categorical(diff.q_pred_indexed(x_known[:, :offset], t),
                                        uniforms[i, 1][:, :offset])
            kl = log_sample_categorical(diff.q_pred_indexed(x_known[:, offset:, :1], t),
                                        uniforms[i, 1][:, offset:, :1])
        if t == 0:
            kp, kl = x_known[:, :offset], x_known[:, offset:, :1]
        return torch.cat([kp, torch.cat([kl, unknown], dim=2)], dim=1)

    def forward(x, i, t, c):
        if use_key:
            u = rand(*x.shape, 2)
            if dsh.enable_kevin_scaled_inference:
                return diff.q_pred_one_timestep_scaled_indexed_sample(x, t, c, dsh.jump_len, u)
            return diff.q_pred_one_timestep_indexed_sample(x, t, u)
        if dsh.enable_kevin_scaled_inference:
            probs = diff.q_pred_one_timestep_scaled_indexed(x, t, c, dsh.jump_len)
        else:
            probs = diff.q_pred_one_timestep_indexed(x, t)
        return log_sample_categorical(probs, uniforms[i, 0])

    n_steps = len(t_lasts)
    for i, (t, rev, c) in enumerate(zip(t_lasts.tolist(), is_reverse.tolist(),
                                        cs.tolist())):
        x = reverse(x, i, t) if rev else forward(x, i, t, c)
        if retain_quant0 and t > dsh.q0_override_steps:
            x[..., 0] = x_quant0  # x is a fresh tensor from the step
        if dsh.progress:
            _progress(i, n_steps)
    return x
