"""Quantized AR decode engine over one or more rows, ``ar_backend="fused"``
(W8A8) and ``"fused4"`` (W4A8) (counterpart of
``mars5_tts_tpu/models/ar_decode_fused.py``).

``FusedEngine`` is the engine object the entry points of
``models/ar_decode`` take (``ar_generate``, ``ar_generate_batched``,
``prefill_state``, ``make_parked_state``, ``decode_chunk``, and a serving
pool's ``ContinuousBatcher(engine=)``): it holds ``prepare_fused``'s pack
and dims, so a caller chooses it once. Each row's prompt is prefilled
through the model as loaded (``CodecLM.prefill``, one row at a time); its
K/V rows are quantized per position into the row's int8 ring of
``window`` slots with per-position scales (``FusedCache``). Every step
then runs each row's last token: embed -> bf16 -> kernel K2
(``ops/kernels/decode_layer.fused_decode_layers``, all rows in one call, the
weight stream shared) -> final RMSNorm of the bf16-rounded rows -> output
head -> the shared sampler of ``models/ar_decode``, and each row's new K/V
rows are quantized into its slot ``position % window``. The head is the
weight-only int8 product (``ops/quant.linear_q8``) or, with ``head4``,
kernel K8 (``ops/kernels/head4.head4_logits``). The decode loop runs the
step as ``FusedStep``: K2 a direct call on the host's positions, and on the
card everything after it, the draw and the next step's embedding one CUDA
graph replay (``models/ar_graphs``), launched one step ahead of the
readback (``decode_loop``).

Unlike the JAX engine, the prompts are not padded to buckets and a short
batch is not padded with parked rows (both only fit XLA's static shapes):
the engine runs exactly the rows it is given, at most ``dims.batch``. A
row's tokens do not depend on the rows beside it: K2's per-row sums are
integer or f64 sums whatever the batch, and the int8 head runs at
``HEAD_ROWS`` rows whatever the batch (cuBLAS picks the head's f32 GEMM
kernel by the row count, so a row's logits would otherwise round one way in
a one-row step and another in a pool's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.decode_layer import (MAX_BATCH, FusedDims, build_fused_pack,
                                        fused_decode_layers, make_dims, quantize_kv_rows)
from ..ops.kernels.head4 import head4_logits, pack_head4
from ..ops.norms import rms_norm
from ..ops.quant import linear_q8, quantize_weight
from ..utils.device import ints_on_device
from .ar import CodecLM, CodecLMConfig
from .ar_decode import ArSampling, DecodeState, Route


@torch.no_grad()
def prepare_fused(codeclm: CodecLM, max_len: int, wbits: int = 8, head4: bool = False,
                  batch: int = 1, int4_mse: bool = True):
    """The decode-time bundle of ``codeclm``: (pack, dims). The pack holds the
    quantized backbone (``build_fused_pack``; ``int4_mse`` as there), the
    output head (int8 per-row, or nibble-packed int4 with ``head4``, which
    needs ``wbits=4``), and the model's final norm weight and embedding
    table. The pack does not depend on ``batch`` (the rows a batched step
    takes, ``dims.batch``)."""
    if head4 and wbits != 4:
        raise ValueError("the int4 head (head4) goes with the int4 backbone (wbits=4)")
    dims = make_dims(codeclm.cfg, max_len, wbits, batch)
    fp = build_fused_pack(codeclm, dims, int4_mse)
    out_w = codeclm.ar.output.weight.detach()
    if head4:
        fp["head4_p"], fp["head4_s"] = pack_head4(out_w)
    else:
        fp["head_q"], fp["head_s"] = quantize_weight(out_w)
    fp["final_norm"] = codeclm.ar.norm.weight.detach()
    fp["embed"] = codeclm.embed.weight.detach()
    return fp, dims


HEAD_ROWS = MAX_BATCH    # rows the int8 head always runs at


def head_logits(fp, h, n_vocab: int):
    """The output head: K8 when the pack carries the int4 head, else the
    int8 weight-only product; (B, V) f32."""
    if "head4_p" in fp:
        return head4_logits(h, fp["head4_p"], fp["head4_s"], n_vocab=n_vocab)
    return linear_q8(h, fp["head_q"], fp["head_s"]).float()


def final_logits(fp, h, cfg):
    """(B, d) f32 hidden rows -> (B, V) f32 logits: the final RMSNorm of the
    bf16-rounded rows, then the head. The int8 head runs at ``HEAD_ROWS``
    rows (the real ones, then zero rows) so that each row's logits are those
    of its own one-row step; K8 takes the real rows alone (its sums are
    integer sums), and the norm's row sums do not depend on the row count."""
    b = h.shape[0]
    hn = rms_norm(h.to(torch.bfloat16), fp["final_norm"], cfg.norm_eps)
    if "head4_p" in fp:
        return head_logits(fp, hn, cfg.n_vocab)
    return head_logits(fp, torch.nn.functional.pad(hn, (0, 0, 0, HEAD_ROWS - b)),
                       cfg.n_vocab)[:b]


class FusedCache:
    """int8 K/V rings (L, B, window, d) with per-position scales
    (L, B, 2, window) (row 0 K, row 1 V)."""

    def __init__(self, dims: FusedDims, device, batch: int = 1):
        L, W, d = dims.n_layers, dims.window, dims.dim
        self.k = torch.zeros((L, batch, W, d), dtype=torch.int8, device=device)
        self.v = torch.zeros_like(self.k)
        self.scales = torch.zeros((L, batch, 2, W), dtype=torch.float32, device=device)

    def write_prompt(self, row: int, kv) -> None:
        """A prefill's per-layer (k, v), each (1, P + 1, H, D), quantized per
        position into slots [0, P + 1) of ``row``."""
        k8, ks = quantize_kv_rows(torch.stack([k[0].flatten(1) for k, _ in kv]))
        v8, vs = quantize_kv_rows(torch.stack([v[0].flatten(1) for _, v in kv]))
        p = k8.shape[1]
        self.k[:, row, :p] = k8
        self.v[:, row, :p] = v8
        self.scales[:, row, 0, :p] = ks
        self.scales[:, row, 1, :p] = vs

    def write_slots(self, pos, k, v) -> None:
        """Quantize (L, B, d) K/V rows into each row's slot ``pos % window``,
        ``pos`` (B,) int64 on the device (nothing read back, so a decode
        graph captures it)."""
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        rows = torch.arange(pos.shape[0], device=pos.device)
        slots = pos % self.k.shape[2]
        self.k[:, rows, slots] = k8
        self.v[:, rows, slots] = v8
        self.scales.permute(1, 3, 0, 2)[rows, slots] = torch.stack([ks, vs], -1).transpose(0, 1)

    def take_row(self, j: int) -> "FusedCache":
        """A one-row copy of row ``j``: its rings and scales."""
        out = FusedCache.__new__(FusedCache)
        out.k, out.v = self.k[:, j:j + 1].clone(), self.v[:, j:j + 1].clone()
        out.scales = self.scales[:, j:j + 1].clone()
        return out

    def put_row(self, b: int, row: "FusedCache") -> None:
        """Overwrite row ``b``'s rings and scales whole with the one-row
        ``row``'s (a parked or finished row's stale slots never survive)."""
        self.k[:, b] = row.k[:, 0]
        self.v[:, b] = row.v[:, 0]
        self.scales[:, b] = row.scales[:, 0]


def fused_step(fp, dims: FusedDims, cfg, tokens, pos, cache: FusedCache):
    """One token of each row (``tokens`` and ``pos``: an int each, or B ints)
    -> (B, V) f32 logits, eager: ``FusedStep``'s layers and head on host
    values; each row's K/V go to its slot pos % window."""
    step = FusedStep(fp, dims, cfg, cache)
    pos = np.atleast_1d(np.asarray(pos, np.int64))
    dev = fp["embed"].device
    x = fp["embed"][ints_on_device(np.atleast_1d(tokens), dev)].to(torch.bfloat16)
    return step.head(*step.layers(x, pos), ints_on_device(pos, dev))


class FusedStep(Route):
    """The quantized engine's decode step as ``decode_loop`` runs it, on
    static tensors of the state (``DeviceState.buffer``): K2 on the input
    rows at the host's cursors (``direct``), then the final norm and the
    head, and each row's K/V quantized into its slot at the device's cursor
    (``body``); after the draw, the next step's input rows embedded from the
    device's last tokens (``feed``). On the card ``body``, the draw and
    ``feed`` replay one CUDA graph a step (``models/ar_graphs``), while K2
    stays a direct call: it plans its attention split on the host's
    positions, and is counted call by call. Pipelined: K2 takes the cursors
    ``decode_loop`` hands it, taken past a step still in flight (a row
    that draws EOS there runs one dropped step at ``cur + 1``; K2's split,
    sized by the largest position, does not change another row's bits), and
    everything else comes from the device state."""

    name, graphable, pipelined = "fused", True, True

    def __init__(self, fp, dims: FusedDims, cfg, cache: FusedCache):
        self.fp, self.dims, self.cfg, self.cache = fp, dims, cfg, cache

    def _static(self, state: DecodeState):
        """The input rows (B, d) bf16, then K2's outputs h (B, d), k_new and
        v_new (L, B, d) f32."""
        dev, b, L, d = state.dev, state.batch, self.dims.n_layers, self.dims.dim
        return (dev.buffer("x", (b, d), torch.bfloat16), dev.buffer("h", (b, d), torch.float32),
                dev.buffer("k", (L, b, d), torch.float32), dev.buffer("v", (L, b, d), torch.float32))

    def layers(self, x, pos, out=None):
        """K2 on input rows ``x`` at host positions ``pos``: (h, k_new, v_new),
        into ``out`` where given."""
        return fused_decode_layers(self.fp, x, pos, self.cache.k, self.cache.v,
                                   self.cache.scales, dims=self.dims, norm_eps=self.cfg.norm_eps,
                                   out=out)

    def head(self, h, k_new, v_new, pos):
        """The logits of K2's ``h``; the K/V rows quantized into the slots of
        ``pos`` (B,) on the device."""
        logits = final_logits(self.fp, h, self.cfg)
        self.cache.write_slots(pos, k_new, v_new)
        return logits

    def direct(self, state: DecodeState, cur) -> None:
        x, *out = self._static(state)
        self.layers(x, cur, out)

    def body(self, state: DecodeState):
        return self.head(*self._static(state)[1:], state.dev.cur)

    def feed(self, state: DecodeState) -> None:
        self._static(state)[0].copy_(self.fp["embed"][state.dev.tok])


class FusedEngine:
    """The quantized decode engine (module docstring) on ``prepare_fused``'s
    ``fp, dims``, with ``models/ar_decode.ModelEngine``'s three answers: a
    ``FusedCache``, stepped by ``FusedStep``, for 1 to ``dims.batch`` rows
    (a serving pool's: 2 to 8; one row is ``ar_generate``'s) whose max_len
    the pack's window covers."""

    def __init__(self, fp, dims: FusedDims):
        self.fp, self.dims = fp, dims

    def fit(self, cfg: CodecLMConfig, s: ArSampling, rows: int, pool: bool = False) -> int:
        """The pack's window, once the engine is known to take ``rows`` rows
        (``pool``: a serving pool's) under ``s``; else ValueError."""
        if pool and not 2 <= rows <= MAX_BATCH:
            raise ValueError(f"fused pool batch_size must be in [2, {MAX_BATCH}]")
        if not 1 <= rows <= self.dims.batch:
            raise ValueError(f"{rows} prompts for an engine of {self.dims.batch} rows")
        if self.dims.window < min(cfg.sliding_window, s.max_len + 1):
            raise ValueError(f"the pack's window {self.dims.window} is too short for max_len "
                             f"{s.max_len}")
        return self.dims.window

    def cache(self, cfg: CodecLMConfig, rows: int, window: int, dtype, device,
              n_heads: int | None = None) -> FusedCache:
        """The empty int8 rings of ``rows`` rows (of the pack's window, whatever
        the prefill's dtype and heads)."""
        return FusedCache(self.dims, device, rows)

    def step(self, model: CodecLM, cache: FusedCache) -> FusedStep:
        """The route that steps ``model``'s pack on ``cache``."""
        return FusedStep(self.fp, self.dims, model.cfg, cache)
