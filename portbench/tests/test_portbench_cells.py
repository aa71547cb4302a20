"""Each cell of BENCHMARK.json runs at tiny geometry on the CPU (the
harness's look for a card skipped) and its result line parses to the
contract's keys; a cell, a configuration and a per-layer metric added as
new files only are found and run."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import run
from tiny import shrink

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977


def parsed(result: dict) -> dict:
    """The result as the driver reads it: one JSON line, ``checks`` last."""
    line = json.dumps(result)
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_at_tiny_geometry(cell):
    out = parsed(run.run_cell(cell, SEED, 0.0, False, device="cpu", override=shrink))
    assert out["attempted"] == 2 and out["failed"] == 0        # one whole cycle of two calls
    assert set(out["metrics"]) == {"rtf", "setup_s"}
    assert out["metrics"]["rtf"]["value"] > 0
    assert out["correct"] is True, out["checks"]


def test_traced_run_reports_per_layer_metrics():
    out = parsed(run.run_cell("mega.shallow-long", SEED, 0.0, True, device="cpu", override=shrink))
    assert {"ar_ms_per_token", "nar_ms_per_step", "codec_ms_per_audio_s", "mfu"} <= set(
        out["metrics"])
    assert "rtf" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_files_alone_add_a_configuration_a_cell_and_a_metric(tmp_path):
    """A copy of the benchmark's folder gains a configuration, a traffic mix,
    a cell's limits and a per-layer metric as new files, and BENCHMARK.json
    new entries; the harness runs the new cell and reads the new metric
    with no edit to its code."""
    home = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", home, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((home / "configs" / "mars5-deploy.json").read_text())
    cfg["name"] = "mars5-deploy-b128"
    cfg["options"]["nar_gen_bucket"] = 128
    (home / "configs" / "mars5-deploy-b128.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "deep.json").read_text())
    mix["deep_clone"] = False
    (home / "traffic" / "shallow.json").write_text(json.dumps(mix))
    limits = json.loads((home / "limits" / "deploy.deep.json").read_text())
    (home / "limits" / "b128.shallow.json").write_text(json.dumps(limits))
    (home / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run['requests']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "mars5-deploy-b128", "source": "x",
                             "file": "portbench/configs/mars5-deploy-b128.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "b128.shallow", "config": "mars5-deploy-b128",
                               "traffic": "shallow", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "rtf",
                               "workloads": ["b128.shallow"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = parsed(run.run_cell("b128.shallow", SEED, 0.0, True, device="cpu", bench_path=path,
                              override=shrink))
    assert out["metrics"]["calls_done"]["value"] == mix["trace_calls"]
    assert out["correct"] is True, out["checks"]


AR_BF16 = '''"""The AR of ar_backend="bf16": every step with the weights as drawn."""

import torch

from .ar import decode_logits, layer_weights, prefill, spk_vector


def prepare(p, cfg, options, control=False):
    return {"p": p, "layers": [layer_weights(p, i) for i in range(cfg["n_layers"])]}


def served_logits(prep, cfg, prompt, spk_codes, served):
    p = prep["p"]
    x = torch.cat([spk_vector(p, spk_codes, cfg)[None], p["embed.weight"][prompt]])
    first, kvs = prefill(p, cfg, x)
    if len(served) == 1:
        return first[None]
    rest = decode_logits(p, cfg, prep["layers"], p["ar.output.weight"], kvs, served[:-1],
                         x.shape[0], None)
    return torch.cat([first[None], rest])
'''


def test_files_alone_add_a_route(tmp_path):
    """A configuration on a route the reference has no module for (the bf16
    AR) reads ``ar_miss`` inf and is not correct; the route's reference
    module added as a new file under ``reference/`` is found by the
    configuration's options and judges it, with no edit to the harness."""
    home = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", home, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((home / "configs" / "mars5-deploy.json").read_text())
    cfg["name"] = "mars5-bf16ar"
    cfg["options"]["ar_backend"] = "bf16"
    (home / "configs" / "mars5-bf16ar.json").write_text(json.dumps(cfg))
    limits = json.loads((home / "limits" / "deploy.deep.json").read_text())
    (home / "limits" / "bf16ar.deep.json").write_text(json.dumps(limits))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "mars5-bf16ar", "source": "x",
                             "file": "portbench/configs/mars5-bf16ar.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "bf16ar.deep", "config": "mars5-bf16ar",
                               "traffic": "deep", "chips": 1, "why": "x"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    def miss():
        out = parsed(run.run_cell("bf16ar.deep", SEED, 0.0, False, device="cpu",
                                  bench_path=path, override=shrink))
        return out, out["checks"]["ar_miss"]["value"]

    out, value = miss()
    assert value is None and out["correct"] is False
    (home / "reference" / "ar_bf16.py").write_text(AR_BF16)
    out, value = miss()
    assert value is not None and value <= limits["ar_miss"], out["checks"]
    assert out["correct"] is True, out["checks"]
