"""The device (H100): one less the union of its activity intervals (kernels,
copies, fills) over the traced window's wall, both from the same trace, as
a percentage."""


def read(run):
    t = run["trace"]
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
