"""Kernel K2 ``fused_decode_layers`` (``ops/kernels/decode_layer.py``): the
summed bound of its calls' work (``portbench/work.k2_step`` at each call's
rows and positions) over the device seconds of its kernel
(``fused_decode_step``) in the trace, as a percentage."""


def read(run):
    t = run["trace"]
    dev = t["kernels"].get("fused_decode_step") if t else None
    if not dev:
        return None
    return 100.0 * run["marks"]["k2_bound_s"] / dev
