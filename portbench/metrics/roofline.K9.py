"""Kernel K9 ``mega_decoder_stack`` (``ops/kernels/nar_mega.py``): the summed
bound of its calls' work (``portbench/work.k9_call``: the whole decoder
stack at the call's rows and valid keys) over the device seconds of the
kernels launched inside the profiler range around each call, as a
percentage."""


def read(run):
    t = run["trace"]
    dev = t["ranges"].get("portbench.K9") if t else None
    if not dev:
        return None
    return 100.0 * run["marks"]["k9_bound_s"] / dev
