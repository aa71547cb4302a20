"""The program's spans as ``portbench/spans.py`` reads them from a traced
run of each cell at tiny geometry on the CPU: the six per-step readings
finite, each span's self time within its host time and its device time
within the trace's busy time, one ``mars5.nar.step`` a reverse step and one
``mars5.ar.step`` a decode step of the traced calls, and every idle gap
inside a ``mars5.request`` named by a host op."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import devicetrace, spans
from tiny import shrink

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 1213
STEPS = ("ar_host_ms_per_step", "ar_device_ms_per_step", "ar_launches_per_step",
         "nar_host_ms_per_step", "nar_device_ms_per_step", "nar_launches_per_step")


def _traced_counts(monkeypatch):
    """The decode steps and the reverse steps run while a profiler records,
    and the events of the traced window."""
    from mars5_tts_torch.diffusion import engine
    from mars5_tts_torch.models import ar_decode

    seen = {"states": [], "T": 0, "evs": None}
    loop, trajectory, events = ar_decode.decode_loop, engine._trajectory, devicetrace.events

    def on():
        return torch.autograd.profiler._is_profiler_enabled

    def run_loop(state, *a, **kw):
        if on():
            seen["states"].append(state)
        return loop(state, *a, **kw)

    def run_trajectory(*a, **kw):
        if on():
            seen["T"] += len(a[11])                  # t_lasts: one entry a step
        return trajectory(*a, **kw)

    def keep(prof):
        seen["evs"] = events(prof)
        return seen["evs"]

    monkeypatch.setattr(ar_decode, "decode_loop", run_loop)
    monkeypatch.setattr(engine, "_trajectory", run_trajectory)
    monkeypatch.setattr(devicetrace, "events", keep)
    return seen


@pytest.mark.parametrize("cell", CELLS)
def test_spans_of_a_traced_run(monkeypatch, cell):
    seen = _traced_counts(monkeypatch)
    result, sp, trace = spans.traced_run(cell, SEED, device="cpu", override=shrink)
    assert result["correct"] is True, result["checks"]
    steps = spans.per_step(sp)
    assert set(steps) == set(STEPS) and all(math.isfinite(v) for v in steps.values())
    for name, s in sp.items():
        assert 0 <= s["self_s"] <= s["host_s"] + 1e-9, name
        assert 0 <= s["device_s"] <= trace["busy_s"], name
        assert 0 <= s["idle_s"] <= s["self_s"] + 1e-9, name
    assert sp["mars5.request"]["count"] == result["attempted"] == 2
    assert sp["mars5.nar.step"]["count"] == seen["T"] > 0
    assert sp["mars5.ar.step"]["count"] == sum(st.steps for st in seen["states"]) > 0
    assert set(sp["mars5.ar.step"]["children"]) == {
        "mars5.ar.forward", "mars5.ar.sample", "mars5.ar.readback"}
    assert set(sp["mars5.nar.step"]["children"]) == {"mars5.nar.decoder", "mars5.nar.tail"}
    # the breakdown's labeller, each request's span as the window: its gaps
    # lie inside the request, and a host op names each
    from torch.autograd import DeviceType
    requests = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in seen["evs"]
                if e.name() == "mars5.request" and e.device_type() == DeviceType.CPU]
    assert len(requests) == 2
    for window in requests:
        gaps = devicetrace.read(seen["evs"], window)["breakdown"]["idle_gaps"]
        assert gaps and all(label != "(no host op)" for label, _ in gaps)
    assert spans.line(sp).startswith("spans {")
