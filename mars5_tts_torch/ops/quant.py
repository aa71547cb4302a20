"""W8A8 quantization of the NAR, and the quantizers of the AR decode engines
(counterpart of ``mars5_tts_tpu/ops/quant.py``).

Weights: symmetric int8 per output row, ``w ~= q * s[:, None]``, kept in
torch's (out, in) layout. Activations: dynamic symmetric int8 per row
(per token). A W8A8 product is an exact int8 x int8 -> int32 GEMM followed by
one f32 rescale ``acc * (xs * s)``, the bias added in f32, and one rounding to
the activation dtype. Rounding is half-to-even (``torch.round``, like
``jnp.round``) and every scale is a true division, as in the JAX package, so
the quantized tensors are bit-identical to its ``quantize_nar`` output.

``quantize_nar`` swaps each quantized weight ``Parameter`` of a
``ResidualTransformer`` for a :class:`QuantWeight` module registered under
the same name, so a quantized state dict reads ``<weight name>.q`` /
``<weight name>.s``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn import functional as F


class QuantWeight(nn.Module):
    """int8 weight ``q`` (out, in) with f32 per-row scales ``s`` (out,)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    @classmethod
    def empty(cls, out_features: int, in_features: int) -> "QuantWeight":
        return cls(torch.zeros((out_features, in_features), dtype=torch.int8),
                   torch.zeros(out_features, dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        # devices follow the module; the scales stay f32 whatever dtype the
        # module is cast to (``q`` is an integer tensor, which casts skip)
        self.q = fn(self.q)
        self.s = self.s.to(self.q.device)
        return self


def is_quantized(w) -> bool:
    return isinstance(w, QuantWeight)


def div(t, c: float):
    """``t / c`` as one rounded division on every device, as the JAX package
    and the kernels compute it (PyTorch's CUDA kernels divide by a Python
    scalar through its reciprocal, which is one ulp off now and then)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def quantize_weight(w, levels: int = 127):
    """Per-row symmetric quantization over the last (input) axis:
    w -> (q int8, scale f32 with the last axis dropped)."""
    wf = w.float()
    scale = div(wf.abs().amax(dim=-1, keepdim=True), levels)
    q = torch.round(wf / scale.clamp_min(1e-12)).clamp(-levels, levels)
    return q.to(torch.int8), scale.squeeze(-1)


def quantize_weight_mse(w, levels: int, ratios=(1.0, 0.9, 0.8, 0.7, 0.6)):
    """Per-row symmetric quantization over the last axis with a clip search:
    each row takes the scale ``amax * r / levels`` whose round trip has the
    smallest squared error (the first ratio wins a tie). The int4 packs use
    it with ``levels=7``. Returns (q int8, scale f32) like ``quantize_weight``."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    best_err = best_scale = None
    for r in ratios:
        scale = (amax * (r / levels)).clamp_min(1e-12)
        q = torch.round(wf / scale).clamp(-levels, levels)
        err = (q * scale - wf).square().sum(dim=-1, keepdim=True)
        if best_err is None:
            best_err, best_scale = err, scale
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_scale = torch.where(take, scale, best_scale)
    q = torch.round(wf / best_scale).clamp(-levels, levels)
    return q.to(torch.int8), best_scale.squeeze(-1)


def linear_q8(x, q, s):
    """Weight-only int8 product ``x @ (q * s).T``: f32 sums, the f32 rescale,
    one rounding to x's dtype. The AR output head of the quantized decode
    engines."""
    return ((x.float() @ q.float().t()) * s).to(x.dtype)


def quantize_act(x):
    """Dynamic per-row int8: (x int8, row scale f32 (..., 1))."""
    xf = x.float()
    xs = div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs


def int8_matmul(a, b):
    """a (..., K) int8 times b (N, K) int8 transposed -> (..., N) int32, exact.

    A library GEMM (``torch._int_mm``), as the JAX package leaves its unfused
    int8 products to XLA. On CUDA, ``_int_mm`` takes more than 16 rows and K, N
    that are multiples of 8; zero padding up to that is exact."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    m, n = a2.shape[0], b.shape[0]
    if a2.is_cuda:
        pk, pn = -k % 8, -n % 8
        if m <= 16 or pk:
            a2 = F.pad(a2, (0, pk, 0, max(17 - m, 0)))
        if pk or pn:
            b = F.pad(b, (0, pk, 0, pn))
        y = torch._int_mm(a2, b.t())[:m, :n]
    else:
        y = torch._int_mm(a2, b.t())
    return y.reshape(*lead, n)


def linear_w8a8(x, q, s, b=None):
    """x (..., in) -> (..., out) in x's dtype: per-row int8 activations, int32
    GEMM, f32 rescale, f32 bias."""
    xq, xs = quantize_act(x)
    y = int8_matmul(xq, q).float() * (xs * s)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def linear_any(x, w, b=None):
    """``linear`` for a plain weight tensor or a :class:`QuantWeight`."""
    if isinstance(w, QuantWeight):
        return linear_w8a8(x, w.q, w.s, b)
    from .attention import linear
    return linear(x, w, b)


def nar_quant_sites(model):
    """(owner module, attribute) of every weight ``quantize_nar`` quantizes:
    the in- and out-projections and the FFN (``activation.W``/``.V``,
    ``linear2``) of every encoder and decoder layer, and the 8 head Linears.
    The speaker encoder stays unquantized, as in the JAX package."""
    for stack in (model.tfm.encoder, model.tfm.decoder):
        for layer in stack.layers:
            attns = [layer.self_attn]
            if hasattr(layer, "multihead_attn"):
                attns.append(layer.multihead_attn)
            for attn in attns:
                yield attn, "in_proj_weight"
                yield attn.out_proj, "weight"
            yield layer.activation.W, "weight"
            yield layer.activation.V, "weight"
            yield layer.linear2, "weight"
    for head in model.residual_decoder:
        yield head[1], "weight"


def set_weight(owner: nn.Module, name: str, w: nn.Module) -> None:
    """Register ``w`` under ``name``, replacing the Parameter held there."""
    delattr(owner, name)
    setattr(owner, name, w)


def quantize_nar(model):
    """A new ``ResidualTransformer`` with W8A8 weights (per-row scales); the
    given model is left as it was. Weights that are already quantized pass
    through, so quantizing twice changes nothing."""
    out = copy.deepcopy(model)
    for owner, name in nar_quant_sites(out):
        w = getattr(owner, name)
        if not isinstance(w, QuantWeight):
            set_weight(owner, name, QuantWeight(*quantize_weight(w.detach())))
    return out
