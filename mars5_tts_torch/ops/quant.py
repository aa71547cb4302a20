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
``<weight name>.s``, or ``<weight name>.sg`` for the per-K-group scales of
a grouped decoder weight (``quantize_nar(w_gsize=)``, the fidelity mode of
kernels K3/K4). ``quantize_codeclm`` does the same to the AR's block
weights and output head, weight-only (``linear_q8``) unless asked for W8A8;
the bf16 AR engine then runs over them.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn import functional as F


class QuantWeight(nn.Module):
    """int8 weight ``q`` (out, in) with f32 scales: per output row ``s``
    (out,), or, for a grouped weight (``quantize_weight_grouped``), per (K
    group, output row) ``sg`` (G, out) and no ``s``, so that a consumer that
    cannot take group scales fails on the missing attribute. ``act_int8``
    (per-row scales only): its products quantize the activations too (W8A8,
    the NAR's) or take them as they are (weight-only, ``linear_q8``)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor | None = None,
                 sg: torch.Tensor | None = None, act_int8: bool = True):
        super().__init__()
        if (s is None) == (sg is None):
            raise ValueError("QuantWeight takes per-row scales s or group scales sg")
        self.act_int8 = act_int8
        self.register_buffer("q", q)
        self.register_buffer("s" if sg is None else "sg", s if sg is None else sg)

    @classmethod
    def empty(cls, out_features: int, in_features: int, groups: int = 0) -> "QuantWeight":
        q = torch.zeros((out_features, in_features), dtype=torch.int8)
        if groups:
            return cls(q, sg=torch.zeros((groups, out_features), dtype=torch.float32))
        return cls(q, torch.zeros(out_features, dtype=torch.float32))

    @property
    def grouped(self) -> bool:
        return "sg" in self._buffers

    @property
    def scales(self) -> torch.Tensor:
        """``sg`` (G, out) of a grouped weight, else ``s`` (out,)."""
        return self.sg if self.grouped else self.s

    def rows(self, start: int, stop: int) -> "QuantWeight":
        """Output rows [start, stop), over the same storage."""
        if self.grouped:
            return QuantWeight(self.q[start:stop], sg=self.sg[:, start:stop])
        return QuantWeight(self.q[start:stop], self.s[start:stop], act_int8=self.act_int8)

    def _apply(self, fn, recurse=True):
        # devices follow the module; the scales stay f32 whatever dtype the
        # module is cast to (``q`` is an integer tensor, which casts skip)
        self.q = fn(self.q)
        name = "sg" if self.grouped else "s"
        setattr(self, name, getattr(self, name).to(self.q.device))
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


def quantize_weight_grouped(w, gsize: int, levels: int = 127):
    """Per (output row, K group of ``gsize`` columns) symmetric quantization:
    w (..., N, K) -> (q (..., N, K) int8, sg (..., G, N) f32), G = K / gsize,
    the group axis ahead of the output axis as the kernels read it. Raises
    ValueError when gsize does not divide K."""
    k = w.shape[-1]
    if gsize <= 0 or k % gsize:
        raise ValueError(f"gsize {gsize} does not divide K={k}")
    wf = w.float().reshape(*w.shape[:-1], k // gsize, gsize)
    sg = div(wf.abs().amax(dim=-1, keepdim=True), levels)          # (..., N, G, 1)
    q = torch.round(wf / sg.clamp_min(1e-12)).clamp(-levels, levels)
    return q.to(torch.int8).reshape(w.shape), sg[..., 0].transpose(-1, -2).contiguous()


def linear_q8(x, q, s, b=None):
    """Weight-only int8 product ``x @ (q * s).T``: f32 sums, the f32 rescale,
    the f32 bias, one rounding to x's dtype. The AR output head of the
    quantized decode engines, and every product of ``quantize_codeclm``'s
    weight-only AR."""
    y = (x.float() @ q.float().t()) * s
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


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


def linear_w8a8_t(x, qt, s, b=None):
    """``linear_w8a8`` against a pre-transposed (in, out) int8 kernel ``qt``."""
    return linear_w8a8(x, qt.t().contiguous(), s, b)


def linear_w8a8_grouped(x, q, sg, b=None):
    """W8A8 with per-K-group scales, the plain product the fused kernels'
    grouped mode replaces off their route: for each of the G groups of K,
    per-row int8 activations of that group, its int32 product with q's
    columns, rescaled ``acc * (xs * sg[g])``; the groups summed in order from
    the first, then the f32 bias, then one rounding to x's dtype. q (N, K)
    int8, sg (G, N) f32."""
    g_count = sg.shape[-2]
    gs = x.shape[-1] // g_count
    xf = x.float()
    out = None
    for g in range(g_count):
        sl = slice(g * gs, (g + 1) * gs)
        xq, xs = quantize_act(xf[..., sl])
        part = int8_matmul(xq, q[:, sl].contiguous()).float() * (xs * sg[g])
        out = part if out is None else out + part
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def linear_any(x, w, b=None):
    """``linear`` for a plain weight tensor or a :class:`QuantWeight` (per-row
    or grouped scales, weight-only or W8A8)."""
    if isinstance(w, QuantWeight):
        if w.grouped:
            return linear_w8a8_grouped(x, w.q, w.sg, b)
        if not w.act_int8:
            return linear_q8(x, w.q, w.s, b)
        return linear_w8a8(x, w.q, w.s, b)
    from .attention import linear
    return linear(x, w, b)


def slice_rows(w, start: int, stop: int):
    """Output rows [start, stop) of a weight tensor or a :class:`QuantWeight`."""
    return w.rows(start, stop) if isinstance(w, QuantWeight) else w[start:stop]


# The JAX package's names of a decoder layer's quantized weights, and the
# site (MARS5_NARF_SITES) whose fused GEMM reads each: only those may be
# grouped. ca_in_w never is: its memory K/V rows take the unfused product.
_GROUP_KEY_SITES = (("sa_in_w", "qkv"), ("sa_out_w", "saout"), ("ca_out_w", "caout"),
                    ("WV", "ffn"), ("lin2_w", "ffn"))


def nar_w_group_keys(sites) -> tuple:
    """The decoder weights (by their JAX names) a grouped ``quantize_nar``
    groups for a set of fused ``sites`` (JAX ``layers.nar_w_group_keys``):
    exactly those whose GEMM runs in K3/K4 there."""
    return tuple(k for k, site in _GROUP_KEY_SITES if site in sites)


def _nar_sites(model):
    """(owner module, attribute, JAX name or None) of every weight
    ``quantize_nar`` quantizes; the JAX name only for the decoder stack's."""
    for stack in (model.tfm.encoder, model.tfm.decoder):
        def key(k, dec=stack is model.tfm.decoder):
            return k if dec else None

        for layer in stack.layers:
            attns = [(layer.self_attn, "sa")]
            if hasattr(layer, "multihead_attn"):
                attns.append((layer.multihead_attn, "ca"))
            for attn, pre in attns:
                yield attn, "in_proj_weight", key(f"{pre}_in_w")
                yield attn.out_proj, "weight", key(f"{pre}_out_w")
            yield layer.activation.W, "weight", key("WV")
            yield layer.activation.V, "weight", key("WV")
            yield layer.linear2, "weight", key("lin2_w")
    for head in model.residual_decoder:
        yield head[1], "weight", None


def nar_quant_sites(model):
    """(owner module, attribute) of every weight ``quantize_nar`` quantizes:
    the in- and out-projections and the FFN (``activation.W``/``.V``,
    ``linear2``) of every encoder and decoder layer, and the 8 head Linears.
    The speaker encoder stays unquantized, as in the JAX package."""
    for owner, name, _ in _nar_sites(model):
        yield owner, name


def set_weight(owner: nn.Module, name: str, w: nn.Module) -> None:
    """Register ``w`` under ``name``, replacing the Parameter held there."""
    delattr(owner, name)
    setattr(owner, name, w)


def quantize_nar(model, w_gsize: int = 0, w_group_keys=()):
    """A new ``ResidualTransformer`` with W8A8 weights; the given model is
    left as it was. Per-row scales, except, with ``w_gsize > 0``, for the
    decoder stack's weights named in ``w_group_keys`` (JAX names, see
    ``nar_w_group_keys``): those take per-K-group scales of ``w_gsize``
    columns (``quantize_weight_grouped``), or per-row scales where
    ``w_gsize`` does not divide their K (as the JAX package falls back).
    Weights already quantized in the requested mode pass through (a model
    quantized throughout is returned as it is), so quantizing twice changes
    nothing; one quantized in the other mode raises ValueError, since int8
    weights cannot be requantized."""
    def want_grouped(w, key):
        k_dim = w.q.shape[-1] if isinstance(w, QuantWeight) else w.shape[-1]
        return w_gsize > 0 and key in w_group_keys and k_dim % w_gsize == 0

    todo = False
    for owner, name, key in _nar_sites(model):
        w = getattr(owner, name)
        if not isinstance(w, QuantWeight):
            todo = True
        elif w.grouped != want_grouped(w, key):
            mode = lambda g: "grouped" if g else "per-row"
            raise ValueError(
                f"quantize_nar: {key or name!r} is already quantized as {mode(w.grouped)} but "
                f"{mode(not w.grouped)} was requested; int8 weights cannot change mode, start "
                "from the bf16 model")
    if not todo:
        return model
    out = copy.deepcopy(model)
    for owner, name, key in _nar_sites(out):
        w = getattr(owner, name)
        if isinstance(w, QuantWeight):
            continue
        if want_grouped(w, key):
            q, sg = quantize_weight_grouped(w.detach(), w_gsize)
            set_weight(owner, name, QuantWeight(q, sg=sg))
        else:
            set_weight(owner, name, QuantWeight(*quantize_weight(w.detach())))
    return out


def quantize_codeclm(model, act_int8: bool = False):
    """A new ``CodecLM`` whose AR blocks' ``wq wk wv wo w1 w2 w3`` and output
    head are int8 with per-output-row scales (``quantize_weight``), weight-only
    products (``linear_q8``) or, with ``act_int8``, W8A8 (``linear_w8a8``);
    the embeddings, norms and speaker encoder stay as they are, and so does
    the given model. The bf16 AR engines run over it (``linear_any``); the
    fused backends pack their own weights and do not take it."""
    out = copy.deepcopy(model)
    owners = [out.ar.output]
    for layer in out.ar.layers:
        a, f = layer.attention, layer.feed_forward
        owners += [a.wq, a.wk, a.wv, a.wo, f.w1, f.w2, f.w3]
    for owner in owners:
        q, s = quantize_weight(owner.weight.detach())
        set_weight(owner, "weight", QuantWeight(q, s, act_int8=act_int8))
    return out
