"""Kernel K10 ``moe_decode`` (``ops/kernels/moe_decode.py``): the summed bound
of the traced calls' K10 work over K10's device seconds, as a percentage.
The work (``portbench/work_moe.k10_step_bound_s``): each call's decode steps
(``n_gen - 1`` a row, from the calls' records) times the configuration's
expert layers, at one row: the k routed experts and the shared ones, as K10
runs them. The device seconds: the trace breakdown's device operations
whose names hold ``moe_decode`` (its two kernels, ``moe_decode_up`` and
``moe_decode_down``, both among the ten largest, else no reading). None
for calls of more than one row and where the kernel is absent."""

from portbench.work_moe import k10_step_bound_s


def read(run):
    t = run["trace"]
    ar = run["config"]["ar"]
    if not t or not ar.get("n_routed_experts"):
        return None
    ops = t["breakdown"]["device_ops"]
    if not all(any(part in n for n, _ in ops) for part in ("moe_decode_up", "moe_decode_down")):
        return None
    rows = [r["ar"] for r in run["requests"]]
    if not rows or any(not r or len(r) != 1 for r in rows):
        return None
    steps = sum(r[0][1] - 1 for r in rows)
    dev = sum(s for n, s in ops if "moe_decode" in n)
    return 100.0 * steps * k10_step_bound_s(ar) / dev
