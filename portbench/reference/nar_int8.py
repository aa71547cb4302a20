"""The NAR of ``nar_backend="int8"`` (W8A8), on the per-layer route (kernels
K3/K4, K1, K6) and on K9 (``nar_mega``) alike: every weight of the encoder
and decoder layers int8 per output row (``mars5_tts_torch/ops/quant.py``
``quantize_nar``), each GEMM's input rows int8; the heads of lanes 1..7
with their LayerNorm affines folded into requantized weights
(``models/nar.py:187-207`` ``fold_quant_heads``), their input rows int8. The
speaker encoder and the timestep MLPs stay as drawn.

The control is this route one precision down: every int8 quantity int4.
"""

from __future__ import annotations

import torch

from . import quant
from .layers import layer_norm
from .nar import step_scores as _step_scores

INT8, INT4 = 127, 7
QUANT_SUFFIXES = ("in_proj_weight", "out_proj.weight", "activation.W.weight",
                  "activation.V.weight", "linear2.weight")


def prepare(p, cfg, options, control: bool = False):
    """The state with the quantized weights dequantized, the folded heads of
    lanes 1..7 as ``heads_w`` (7, K, D) and ``heads_b`` (7, K), and the
    route's ``levels``."""
    levels = INT4 if control else INT8
    q = dict(p)
    for k, v in p.items():
        if k.startswith("tfm.") and k.endswith(QUANT_SUFFIXES):
            q[k] = quant.rows(v, levels)
    ws, bs = [], []
    for i in range(1, cfg["pred_quant_levels"]):
        pre = f"residual_decoder.{i}."
        wf = quant.rows(p[pre + "1.weight"], levels)
        ws.append(quant.rows(wf * p[pre + "0.weight"][None, :], levels))
        bs.append(wf @ p[pre + "0.bias"] + p[pre + "1.bias"])
    q["heads_w"], q["heads_b"] = torch.stack(ws), torch.stack(bs)
    q["levels"] = levels
    return q


def heads(q, out):
    """Folded heads of lanes 1..7: (R, L, 7, K) logits. The heads' shared
    normalisation has no affine (eps 1e-5)."""
    n = quant.act(layer_norm(out, eps=1e-5), q["levels"])
    w, b = q["heads_w"], q["heads_b"]
    y = n @ w.reshape(-1, w.shape[-1]).t() + b.reshape(-1)
    return y.reshape(*out.shape[:2], w.shape[0], w.shape[1])


def step_scores(q, cfg, step, batch, tables, s):
    """One recorded reverse step's scores (``nar.step_scores``)."""
    return _step_scores(q, cfg, step, batch, tables, heads, q["levels"], s)
