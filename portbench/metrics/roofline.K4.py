"""Kernel K4 ``fused_ffn`` (``ops/kernels/nar_fused.py``): the summed bound of
its calls' work (``portbench/work.k4_call``) over the device seconds of the
kernels launched inside the profiler range around each call, as a
percentage."""


def read(run):
    t = run["trace"]
    dev = t["ranges"].get("portbench.K4") if t else None
    if not dev:
        return None
    return 100.0 * run["marks"]["k4_bound_s"] / dev
