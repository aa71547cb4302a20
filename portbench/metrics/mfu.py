"""The whole model step, AR and NAR: the model FLOPs of the traced calls
(``portbench/flops.py``) over the traced window's wall seconds times the
H100's int8 peak (1,979 TOP/s; both configurations run their GEMMs in
int8), as a percentage."""

from portbench.work import PEAK_OPS_S


def read(run):
    t = run["trace"]
    if not t or not t["window_s"] or not run["flops"]:
        return None
    return 100.0 * run["flops"] / (t["window_s"] * PEAK_OPS_S["int8"])
