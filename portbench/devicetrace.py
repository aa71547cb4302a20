"""Readings of one ``torch.profiler`` window, taken from its raw event list
(kept in memory; no trace file is written).

The device's activity (kernels, copies, fills) as merged intervals; its busy
seconds are their union over the traced window, so overlapping kernels count
once. A profiler range's device seconds are those of the kernels launched
inside it on the host: a kernel is matched to its launch call by the
profiler's correlation id, else to the host operation it ran under. Idle
gaps are labelled with the innermost host operation running at their
midpoint.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


def events(prof):
    return prof.profiler.kineto_results.events()


def window_of(evs, name: str):
    """(start_ns, end_ns) of the host range ``name`` (the traced window)."""
    from torch.autograd import DeviceType

    for e in evs:
        if e.name() == name and e.device_type() == DeviceType.CPU:
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise RuntimeError(f"no profiler range {name!r} in the trace")


def read(evs, window: tuple, ranges=(), kernels=()) -> dict:
    """Readings of the window (t0_ns, t1_ns) on the profiler's clock:
    ``busy_s`` and ``window_s``, device seconds by kernel name, of each name
    in ``ranges`` (kernels launched inside those host ranges) and of the
    kernels whose names contain a string of ``kernels``, and ``breakdown``
    (the ten device operations that took most time and the ten longest idle
    gaps, by what the host was doing)."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    t0, t1 = window
    d_start, d_end, d_name, d_corr, d_link = [], [], [], [], []
    h_start, h_end, h_name = [], [], []
    launches, ops = {}, {}
    annot = defaultdict(list)
    for e in evs:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != cpu:
            if name.startswith("portbench."):         # the ranges' device-side copies
                continue
            if end <= t0 or start >= t1:
                continue
            d_start.append(max(start, t0))
            d_end.append(min(end, t1))
            d_name.append(name)
            d_corr.append(e.correlation_id())
            d_link.append(e.linked_correlation_id())
            continue
        if name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = start
        else:
            ops[e.correlation_id()] = start
        if name in ranges:
            annot[name].append((start, end))
        elif t0 <= start < t1 and not name.startswith("portbench."):
            h_start.append(start)
            h_end.append(end)
            h_name.append(name)
    ds, de = np.asarray(d_start, np.int64), np.asarray(d_end, np.int64)
    order = np.argsort(ds, kind="stable")
    ms, me = ds[order], de[order]
    # merged intervals: a new one starts where the running end falls behind
    run_end = np.maximum.accumulate(me) if len(me) else me
    new = np.ones(len(ms), bool)
    new[1:] = ms[1:] > run_end[:-1]
    starts = ms[new]
    ends = run_end[np.r_[np.flatnonzero(new)[1:] - 1, len(ms) - 1]] if len(ms) else me
    busy = int((ends - starts).sum())
    dur = (de - ds) / 1e9
    by_name = defaultdict(float)
    for n, s in zip(d_name, dur.tolist()):
        by_name[n] += s
    matched = {"launch": 0, "op": 0, "none": 0}
    launched_at = np.empty(len(ds), np.int64)
    for i, (c, l) in enumerate(zip(d_corr, d_link)):
        if c > 0 and c in launches:
            launched_at[i] = launches[c]
            matched["launch"] += 1
        elif l > 0 and l in ops:
            launched_at[i] = ops[l]
            matched["op"] += 1
        else:
            launched_at[i] = -1
            matched["none"] += 1
    in_range = {}
    for r in ranges:
        sp = sorted(annot.get(r, ()))
        if not sp:
            in_range[r] = None
            continue
        a = np.asarray([x for x, _ in sp], np.int64)
        b = np.asarray([y for _, y in sp], np.int64)
        k = np.searchsorted(a, launched_at, side="right") - 1
        inside = (launched_at >= 0) & (k >= 0) & (launched_at < b[np.maximum(k, 0)])
        in_range[r] = float(dur[inside].sum())
    named = {k: sum(v for n, v in by_name.items() if k in n) for k in kernels}
    gap_a = np.concatenate([[t0], ends]).astype(np.int64)
    gap_b = np.concatenate([starts, [t1]]).astype(np.int64)
    g = gap_b - gap_a
    hs, he = np.asarray(h_start, np.int64), np.asarray(h_end, np.int64)
    top_gaps = []
    for j in np.argsort(-g)[:10]:
        if g[j] <= 0:
            break
        mid = (gap_a[j] + gap_b[j]) // 2
        cover = np.flatnonzero((hs <= mid) & (mid < he))
        label = h_name[cover[np.argmin(he[cover] - hs[cover])]] if len(cover) else "(no host op)"
        top_gaps.append([label, float(g[j]) / 1e9])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9, "ranges": in_range,
            "kernels": named, "matched": matched,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": top_gaps}}
