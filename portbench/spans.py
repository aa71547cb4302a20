#!/usr/bin/env python3
"""The program's spans in one traced window: what each ``mars5.*`` range of
``mars5_tts_torch`` (``utils/profiling.span``: a request, its stages, the AR's
prefill and decode steps, the NAR's encoder memory and reverse steps) took on
the host and on the device, read from the profiler's raw events.

    python3 portbench/spans.py --workload <cell> --seed <n>

runs one traced run of the cell (``run.run_cell`` with ``--trace 1``), prints
its ``spans`` line to standard error and ends standard output with one JSON
object: ``steps`` (the six readings a step of ``per_step``), ``spans`` (the
table of ``read``), ``kernels`` (the device seconds of K2's kernels,
``fused_decode_step``), ``result`` (the run's result line). The harness's own
``run.py`` does not read the spans yet; this is their reader until it does.

An operator reads the same spans in their own ``torch.profiler`` trace of
``Mars5TTS.tts`` or ``.tts_batch``: ``read(prof.profiler.kineto_results.events(),
window)`` with the window (start_ns, end_ns) of any range around the calls
(``devicetrace.window_of``), or the ranges' names in the trace viewer.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import devicetrace  # noqa: E402

PREFIX = "mars5."


def _merged(starts, ends):
    """The union of intervals (starts, ends) as sorted disjoint (starts, ends),
    merged as ``devicetrace.read`` merges the device's activity."""
    s, e = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    ms, me = s[order], e[order]
    run_end = np.maximum.accumulate(me)
    new = np.ones(len(ms), bool)
    new[1:] = ms[1:] > run_end[:-1]
    return ms[new], run_end[np.r_[np.flatnonzero(new)[1:] - 1, len(ms) - 1]]


def _busy_before(starts, ends):
    """B(t): the device's busy nanoseconds before t, for arrays of t."""
    before = np.concatenate([[0], np.cumsum(ends - starts)])

    def busy(t):
        t = np.asarray(t, np.int64)
        if not len(starts):
            return np.zeros_like(t)
        k = np.searchsorted(starts, t, side="right") - 1
        kk = np.maximum(k, 0)
        part = np.clip(t - starts[kk], 0, ends[kk] - starts[kk])
        return np.where(k >= 0, before[kk] + part, 0)
    return busy


def read(evs, window: tuple) -> dict:
    """For each ``mars5.*`` name that starts in the window (t0_ns, t1_ns):
    ``count``; ``host_s``, its spans' summed duration; ``self_s``, ``host_s``
    less its direct child spans (the ``mars5.*`` spans nested in it on the
    same thread, none between); ``device_s``, the device seconds of the
    kernels launched inside it (``devicetrace.read`` with the names as
    ranges); ``launches``, the launch calls (``devicetrace.LAUNCH_PREFIXES``)
    of its thread that start inside it; ``idle_s``, the device's idle time
    inside its self intervals (the device's activity merged as
    ``devicetrace.read`` merges it); ``children``, each direct child name's
    summed ``host_s`` inside it."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    t0, t1 = window
    spans, d_start, d_end = [], [], []
    launches = defaultdict(list)
    for e in evs:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != cpu:
            if name.startswith("portbench.") or end <= t0 or start >= t1:
                continue
            d_start.append(max(start, t0))
            d_end.append(min(end, t1))
        elif name.startswith(devicetrace.LAUNCH_PREFIXES):
            launches[e.start_thread_id()].append(start)
        elif name.startswith(PREFIX) and t0 <= start < t1:
            spans.append((start, -end, name, e.start_thread_id()))
    busy = _busy_before(*_merged(d_start, d_end))
    launches = {th: np.sort(np.asarray(v, np.int64)) for th, v in launches.items()}

    # each span's direct parent: a walk over each thread's spans in order
    spans.sort(key=lambda s: (s[3], s[0], s[1]))
    start = np.asarray([s[0] for s in spans], np.int64)
    end = -np.asarray([s[1] for s in spans], np.int64)
    parent = np.full(len(spans), -1)
    stack, thread = [], None
    for i, (_, _, _, th) in enumerate(spans):
        if th != thread:
            stack, thread = [], th
        while stack and end[stack[-1]] <= start[i]:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    dur = end - start
    idle = dur - (busy(end) - busy(start))
    n_launch = np.zeros(len(spans), np.int64)
    for i, (_, _, _, th) in enumerate(spans):
        ls = launches.get(th)
        if ls is not None:
            n_launch[i] = np.searchsorted(ls, end[i]) - np.searchsorted(ls, start[i])
    self_ns, self_idle = dur.astype(np.float64), idle.astype(np.float64)
    children = defaultdict(lambda: defaultdict(float))
    for i in np.flatnonzero(parent >= 0):
        p = parent[i]
        self_ns[p] -= dur[i]
        self_idle[p] -= idle[i]
        children[spans[p][2]][spans[i][2]] += float(dur[i]) / 1e9

    names = sorted({s[2] for s in spans})
    device = devicetrace.read(evs, window, ranges=tuple(names))["ranges"] if names else {}
    out = {}
    for name in names:
        mine = np.asarray([s[2] == name for s in spans])
        out[name] = {"count": int(mine.sum()), "host_s": float(dur[mine].sum()) / 1e9,
                     "self_s": float(self_ns[mine].sum()) / 1e9,
                     "device_s": device.get(name) or 0.0,
                     "launches": int(n_launch[mine].sum()),
                     "idle_s": float(self_idle[mine].sum()) / 1e9,
                     "children": dict(children.get(name, {}))}
    return out


def per_step(spans: dict) -> dict:
    """A step's readings of the AR's decode step (``mars5.ar.step``) and the
    NAR's reverse step (``mars5.nar.step``), where the window has any:
    ``ar_host_ms_per_step`` (the step's host time less its readback's, where
    the host waits for the device), ``ar_device_ms_per_step``,
    ``ar_launches_per_step`` (PyTorch's own launches included),
    ``nar_host_ms_per_step`` (the step's host time: it queues the step and
    reads nothing back), ``nar_device_ms_per_step``,
    ``nar_launches_per_step``."""
    out = {}
    for layer in ("ar", "nar"):
        s = spans.get(f"{PREFIX}{layer}.step")
        if not s or not s["count"]:
            continue
        n = s["count"]
        wait = s["children"].get(f"{PREFIX}ar.readback", 0.0) if layer == "ar" else 0.0
        out[f"{layer}_host_ms_per_step"] = 1e3 * (s["host_s"] - wait) / n
        out[f"{layer}_device_ms_per_step"] = 1e3 * s["device_s"] / n
        out[f"{layer}_launches_per_step"] = s["launches"] / n
    return out


def traced_run(cell: str, seed: int, **kw):
    """One traced run of ``cell`` (``run.run_cell`` with ``trace=True`` and
    ``kw``); returns (its result, the spans of its window, the trace's
    readings). The spans are read from the events ``run_cell`` passes to
    ``devicetrace.read``."""
    from portbench import run

    got = {}
    inner = devicetrace.read

    def reading(evs, window, **kws):
        devicetrace.read = inner
        got["spans"] = read(evs, window)
        got["trace"] = inner(evs, window, **kws)
        return got["trace"]

    devicetrace.read = reading
    try:
        result = run.run_cell(cell, seed, 0.0, True, **kw)
    finally:
        devicetrace.read = inner
    return result, got["spans"], got["trace"]


def line(spans: dict) -> str:
    """The ``spans`` line of standard error: each name's readings, rounded."""
    return "spans " + json.dumps({n: {k: (round(v, 6) if isinstance(v, float) else v)
                                      for k, v in s.items() if k != "children"}
                                  for n, s in spans.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    result, sp, trace = traced_run(args.workload, args.seed)
    print(line(sp), file=sys.stderr, flush=True)
    print(json.dumps({"steps": per_step(sp), "spans": sp, "kernels": trace["kernels"],
                      "result": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
