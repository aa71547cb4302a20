"""The work of kernel K10 (``moe_decode``, ``ops/kernels/moe_decode.py``): one
decode step's mixture of experts in one expert layer, counted from the
configuration's shapes as the work of the function it computes: every
weight byte of the experts the rows chose read once, the rows in and out,
their ids and weights, and the multiply-adds those inputs need. A later
change that fuses, splits or replaces the kernel leaves these counts as
they are.
"""

from __future__ import annotations

from .work import bound


def k10_call(dim: int, inner: int, experts: int, shared_inner: int, rows: int, k: int):
    """One call over ``rows`` rows that chose ``experts`` distinct experts of
    width ``inner`` (k each), with the shared experts' SwiGLU of
    ``shared_inner``: (bytes, bf16 operations)."""
    weights = 3 * dim * (experts * inner + shared_inner) * 2
    nb = weights + 2 * rows * dim * 2 + rows * k * 8
    ops = 2 * 3 * dim * rows * (k * inner + shared_inner)
    return nb, ops


def k10_step_bound_s(ar: dict) -> float:
    """The bound of one decode step of one row through every expert layer of
    the configuration's AR (``ar``: its ``CodecLMConfig`` fields): the k
    routed experts and the shared ones, a call a layer."""
    k = ar["n_experts_per_tok"]
    nb, ops = k10_call(ar["dim"], ar["moe_hidden_dim"], k,
                       ar["n_shared_experts"] * ar["moe_hidden_dim"], 1, k)
    return (ar["n_layers"] - ar["first_k_dense"]) * bound(nb, bf16=ops)[0]
