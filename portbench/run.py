#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``mars5_tts_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the checkout's root: its
configuration (``portbench/configs/<config>.json``: widths and the
``Mars5TTS`` options) and its traffic mix (``portbench/traffic/<mix>.json``,
read by the generator the mix names). Set-up: builds the port's CUDA
libraries, draws the seed's weights on the card, builds ``Mars5TTS`` through
``from_params`` and serves one warm-up call: the cycle's longest output with
its longest references, at its own T.
The window then sends the cycle's calls one after the other, whole cycles
until ``--seconds`` have passed, and ends with the last call's completion
(so every run's window holds the same calls); with ``--trace 1`` it sends
the cycle's first ``trace_calls`` calls under ``torch.profiler``. After
it, the program is freed and the plain reference judges a sample of what
the window produced (``portbench/check.py``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, each read by ``portbench/metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit (``portbench/limits/<cell>.json``), which
also end standard error.

Exits 2 without a result when PyTorch sees no card or fewer than the cell
asks for, when the program cannot be imported, and when ``jax``, ``jaxlib``,
``flax`` or ``mars5_tts_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mars5_tts_tpu")
WINDOW = "portbench.window"


class Refused(RuntimeError):
    """A run that prints no result (exit code 2)."""


def load_cell(name: str, bench_path: Path) -> dict:
    """The cell's entry, configuration, traffic mix, metrics and limits."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in {bench_path}")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((bench_path.parent / cfgs[cell["config"]]["file"]).read_text())
    home = bench_path.parent / bench["paths"][0]
    traffic = json.loads((home / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    limits_path = home / "limits" / f"{name}.json"
    return {"cell": cell, "config": cfg, "traffic": traffic, "home": home,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)],
            "limits": json.loads(limits_path.read_text()) if limits_path.exists() else {}}


def finite(v):
    """``v`` as a float, or None where it is missing or not finite (JSON has
    no infinity)."""
    return float(v) if v is not None and math.isfinite(v) else None


def generator(name: str):
    return importlib.import_module(f"portbench.traffic.{name}")


def reader(home: Path, metric: str):
    """``<home>/metrics/<metric>.py``'s ``read`` (home: the benchmark's folder)."""
    path = home / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def serve(tts, req, entry: str, inference: dict):
    """Sends one call with the settings it states (``check.stated``: every
    setting of the configuration's ``inference``, the AR capped at the
    call's drawn frames and the early-EOS estimate past the cap); returns
    the audio frames of each row."""
    from mars5_tts_torch import InferenceConfig

    from portbench.check import stated

    cfg = InferenceConfig(**stated(req, inference)["settings"])
    if entry == "tts":
        codes, _ = tts.tts(req.texts[0], req.refs[0], ref_transcript=req.transcripts[0],
                           cfg=cfg, seed=req.seed)
        outs = [codes]
    else:
        outs = [c for c, _ in tts.tts_batch(req.texts, req.refs, req.transcripts, cfg=cfg,
                                            seed=req.seed)]
    return [len(c) - (f if req.deep_clone else 0) for c, f in zip(outs, req.ref_frames)]


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench_path: Path = ROOT / "BENCHMARK.json", override=None, faults=None,
             control: bool = False, calls: int | None = None) -> dict:
    """One run of cell ``name``. ``override(spec)`` may change the loaded
    configuration and traffic (the CPU tests' tiny geometry); ``faults(tts)``
    breaks the timed path under the recorder (the tests of ``correct``);
    ``control`` also reads the control's numbers (``result["control"]``);
    ``calls`` ends the window after that many calls (the cycle's first two
    are its shortest and its longest; ``portbench/readings.py``)."""
    import numpy as np
    import torch

    from portbench import check, flops, weights
    from portbench.record import Marks, Pinned, Recorder, arena_bytes

    spec = load_cell(name, bench_path)
    if override is not None:
        override(spec)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger().setLevel(logging.ERROR)
    hop = int(np.prod(cfg["encodec"]["ratios"]))
    sr = cfg["encodec"]["sample_rate"]
    if dev.type == "cuda":
        from mars5_tts_torch.ops.kernels.build import build_all
        build_all()
    gen = generator(traffic["generator"])
    cycle = gen.requests(traffic, seed, sample_rate=sr, hop=hop, frame_rate=sr / hop)
    tts = weights.build_program(cfg, seed, dev)
    entry = traffic["entry"]
    if calls or trace:
        n_window = calls or traffic.get("trace_calls", 1)
    else:
        n_window = len(cycle)
    keep = check.chosen(cycle, n_window, seed)
    arena = Pinned(arena_bytes(cycle, keep, cfg["nar"]["n_quant"], hop), dev)
    if faults is not None:          # under the recorder: it keeps what the faults make
        faults(tts)
    rec = Recorder(tts, seed, cfg["options"].get("guidance_interval", (0.0, 1.0)), keep, arena)
    rec.install()
    marks = Marks() if trace else None
    if marks:
        marks.install()
    # the warm-up, its outputs kept as a compared call's are: every kernel,
    # pack and copy the window's calls use, and the allocator grown to the
    # largest of them: the cycle's longest output with its longest
    # references, at the cycle's own T
    warm = gen.largest(traffic, seed, sample_rate=sr, hop=hop, frame_rate=sr / hop)
    rec.begin(warm, -1, kept=True)
    rec.finish(serve(tts, warm, entry, cfg["inference"]), {}, 0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec.reset()
    if marks:      # the warm-up's calls are not the window's
        marks.reset()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        span = record_function(WINDOW)
        span.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    attempted = failed = 0
    i = 0
    t_end = t0
    while True:
        req = cycle[i % len(cycle)]
        rec.begin(req, i)
        i += 1
        attempted += 1
        t_req = time.perf_counter()
        try:
            frames = serve(tts, req, entry, cfg["inference"])
        except Exception as exc:             # a failed call counts, and the loop goes on
            logging.error("call %d failed: %r", i, exc)
            failed += 1
            rec.cur = None
            frames = None
        t_end = time.perf_counter()
        if frames is not None:
            rec.finish(frames, dict(tts.last_timing.get("stages_s", {})), t_end - t_req)
        if calls or trace:
            done = i >= n_window
        else:       # whole cycles: every run's window holds the same calls
            done = i % len(cycle) == 0 and t_end - t0 >= seconds
        if done:
            break
    window_s = t_end - t0
    if trace:
        span.__exit__(None, None, None)
        prof.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dev_info = device_info(torch, dev, spec["cell"].get("chips", 1))
    rec.uninstall()
    if marks:
        marks.uninstall()

    recs = rec.requests
    audio_s = sum(sum(r["frames"]) for r in recs) * hop / sr
    for r in recs:
        print("call " + json.dumps({"frames": r["frames"], "wall_s": round(r["wall_s"], 4),
                                    "compared": r["kept"],
                                    "stages": {k: round(v, 4) for k, v in r["stages"].items()}}),
              file=sys.stderr)
    run = {"requests": recs, "window_s": window_s, "audio_s": audio_s, "setup_s": setup_s,
           "peak_bytes": dev_info["memory_peak_bytes"], "config": cfg, "trace": None,
           "flops": sum(flops.request_flops(r, cfg) for r in recs)}
    breakdown = None
    if trace:
        from portbench import devicetrace
        evs = devicetrace.events(prof)
        run["trace"] = devicetrace.read(evs, devicetrace.window_of(evs, WINDOW),
                                        ranges=(Marks.K4, Marks.K9),
                                        kernels=("fused_decode_step",))
        run["marks"] = {"k2_bound_s": marks.k2_bound_s, "k4_bound_s": marks.k4_bound_s,
                        "k9_bound_s": marks.k9_bound_s()}
        breakdown = run["trace"]["breakdown"]
        print("trace " + json.dumps({k: run["trace"][k] for k in (
            "ranges", "kernels", "matched")} | run["marks"]),
              file=sys.stderr)
        dev_info.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        del prof, evs

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = reader(spec["home"], m["name"])(run)
            if finite(v) is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"rtf": window_s / audio_s if audio_s else None, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if finite(values[m["name"]]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # the program's state goes before the reference runs
    del tts
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(recs, cfg, seed, dev, home=spec["home"])
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    limits = spec["limits"]
    checks = {k: {"value": finite(v), "limit": limits.get(k)} for k, v in numbers.items()}
    result["correct"] = (failed == 0 and bool(recs) and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    if control:
        result["control"] = check.compare(recs, cfg, seed, dev, control=True,
                                          home=spec["home"])
    result["checks"] = checks
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise Refused(f"modules loaded in the run's process: {loaded}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        bench = load_cell(args.workload, ROOT / "BENCHMARK.json")
        chips = int(bench["cell"].get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"this run needs {chips} CUDA device(s); PyTorch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        try:
            importlib.import_module("mars5_tts_torch")
        except ImportError as exc:
            raise Refused(f"the program does not import: {exc}") from exc
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
