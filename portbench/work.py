"""The work a call or a request needs, counted from its shapes, and the
H100's published peaks.

``HBM_BYTES_S``, ``PEAK_OPS_S``, ``bound`` and ``nbytes`` are frozen copies
of ``chip_smoke.py:209-229`` (NVIDIA's H100 SXM data sheet: 3.35 TB/s HBM,
1,979 TOP/s int8 and 989 TFLOP/s bf16, dense). The counts of kernels K2
(``chip_smoke.check_decode_layer``, ``chip_smoke.py:942-1004``), K4
(``check_nar_fused``, ``:464-507``) and K9 (``mega_bound``, ``:1317-1327``)
are restated here as the work of the function each kernel computes: every
input byte read once, every output byte written once, and the operations
those inputs need. A later change that fuses, splits or replaces a kernel
leaves these counts as they are.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}


def bound(nbytes, **ops):
    """(bound_s, bound_by): the larger of moving ``nbytes`` at the HBM rate and
    doing ``ops`` (type -> count) at each type's peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k2_step(n_layers, dim, hidden, wbits, window, positions):
    """One decode step of K2 (the quantized AR backbone) for rows at
    ``positions``: (bytes, int8 operations). The weights once, their f32
    scales, the norms, each row's valid int8 ring slots with their two f32
    scales, the bf16 input rows, and the f32 outputs (h, k_new, v_new)."""
    rows = len(positions)
    elems = n_layers * (3 * dim * dim + dim * dim + 2 * hidden * dim + dim * hidden)
    scales = n_layers * 4 * ((3 * dim + dim + 2 * hidden) * (2 if wbits == 4 else 1) + dim)
    slots = sum(min(p, window - 1) for p in positions)
    ring = n_layers * slots * (2 * dim + 8)
    nb = (elems * wbits // 8 + scales + n_layers * 2 * dim * 4 + ring + rows * dim * 2
          + rows * dim * 4 + 2 * n_layers * rows * dim * 4)
    ops = 2 * elems * rows + n_layers * 4 * dim * slots
    return nb, ops


def k4_call(m, dim, hidden):
    """One call of K4 (the int8 FFN of a decoder layer with its LN prologue)
    over ``m`` rows: (bytes, int8 operations)."""
    nb = (m * dim * 2 + 2 * dim * 2 + 3 * hidden * dim + (2 * hidden + dim) * 4 + dim * 2
          + m * dim * 2)
    return nb, 2 * m * 3 * dim * hidden


def k9_call(n_layers, b, l, lk, dim, hidden, nhead, valid_self, valid_mem):
    """One call of K9 (the int8 decoder stack) on (b, l) rows over a (b, lk)
    memory: (bytes, int8 operations, bf16 operations). ``valid_self`` and
    ``valid_mem``: the unmasked frames and memory tokens, summed over rows."""
    rows, mk = b * l, b * lk
    int8_ops = n_layers * (2 * rows * (6 * dim * dim + 3 * hidden * dim)
                           + 2 * mk * 2 * dim * dim)
    hd = dim // nhead
    bf16_ops = n_layers * 4 * nhead * l * hd * (valid_self + valid_mem)
    weights = n_layers * (9 * dim * dim + 3 * hidden * dim)
    vectors = n_layers * 4 * (12 * dim + 3 * hidden)
    nb = rows * dim * 2 * 2 + mk * dim * 2 + b * (l + lk) + weights + vectors
    return nb, int8_ops, bf16_ops
