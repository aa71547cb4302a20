"""``correct`` comes out false when the timed path is broken underneath the
recorder, once for each fault a served cell can have (the runs skip the
harness's look for a card and run the rest at tiny geometry on the CPU), and
when the control (the reference at the precision below the configuration's)
stands in for the program: at tiny geometry on the CPU, where it fails
``ar_miss``, and in the ``cuda`` test at the end, at each cell's own size,
where the limits were set (the CPU has no TF32, and at tiny widths the
NAR's scores are too small for the control to cross ``nar_gap``'s limit)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from tiny import shrink

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242


def unchanged_step(tts):
    """A reverse step that returns its state unchanged: the tail hands back x_t."""
    from mars5_tts_torch.diffusion import engine

    for name in ("heads_diffusion_tail", "diffusion_tail"):
        setattr(engine, name, lambda *a, **kw: a[4].clone())


def altered_token(tts):
    """A token altered where it is produced: the AR's draw moved to the next id."""
    from mars5_tts_torch.models import ar_decode

    fn = ar_decode.sample_from_logprobs

    def moved(lp, u):
        tok = fn(lp, u)
        return torch.where(tok < 1281, tok + 1, tok - 1)
    ar_decode.sample_from_logprobs = moved


def no_penalties(tts):
    """The AR's frequency and presence penalties left out."""
    from mars5_tts_torch.models import ar_decode

    ar_decode.freq_presence_penalty = lambda logits, *a, **kw: logits


def dropped_guidance(tts):
    """CFG left out on one reverse step inside the guidance interval (its
    last), the step's conditional rows alone."""
    from mars5_tts_torch.diffusion import engine

    fn = engine._cfg_steps

    def one_less(dsh, T):
        inner = fn(dsh, T)
        last = int(round(dsh.guidance_interval[1] * T)) - 1
        return lambda t: inner(t) and t != last
    engine._cfg_steps = one_less


def altered_code(tts):
    """An answer altered where it is produced: the NAR tail's codes moved by one."""
    from mars5_tts_torch.diffusion import engine

    for name in ("heads_diffusion_tail", "diffusion_tail"):
        fn = getattr(engine, name)
        setattr(engine, name, lambda *a, _fn=fn, **kw: (_fn(*a, **kw) + 1) % 1025)


FAULTS = [("deploy.deep", unchanged_step, "nar_gap"),
          ("deploy.deep", altered_token, "ar_miss"),
          ("deploy.deep", no_penalties, "ar_miss"),
          ("deploy.deep", dropped_guidance, "nar_gap"),
          ("mega.shallow-long", altered_code, "nar_gap"),
          ("mega.shallow-long", dropped_guidance, "nar_gap")]


@pytest.fixture
def restore():
    """Puts back what a fault replaced."""
    from mars5_tts_torch.diffusion import engine
    from mars5_tts_torch.models import ar_decode

    saved = [(engine, n, getattr(engine, n))
             for n in ("heads_diffusion_tail", "diffusion_tail", "_cfg_steps")]
    saved += [(ar_decode, n, getattr(ar_decode, n))
              for n in ("sample_from_logprobs", "freq_presence_penalty")]
    yield
    for owner, name, fn in saved:
        setattr(owner, name, fn)


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{f[0]}-{f[1].__name__}" for f in FAULTS])
def test_fault_comes_out_not_correct(cell, fault, number, restore):
    out = run.run_cell(cell, SEED, 0.0, False, device="cpu", override=shrink, faults=fault)
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("cell", ["deploy.deep", "mega.shallow-long"])
def test_control_fails_at_tiny_geometry(cell):
    """The program's run of the cycle's shortest and longest calls is within
    every limit; the control's reading of the same calls is not."""
    out = run.run_cell(cell, SEED, 0.0, False, device="cpu", override=shrink, control=True,
                       calls=2)
    assert out["correct"] is True, out["checks"]
    assert any(v > out["checks"][k]["limit"] for k, v in out["control"].items()), out


@pytest.mark.cuda
def test_control_fails_on_the_card_at_each_cells_size():
    """The control on three seeds at each cell's own size: it fails one of
    the cell's numbers on every seed, and the program none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        limits = json.loads((ROOT / "portbench" / "limits" / f"{w['name']}.json").read_text())
        seeds = [str(3_100_000_000 + k) for k in range(3)]
        proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "readings.py"),
                               "--workload", w["name"], "--seeds", *seeds],
                              capture_output=True, text=True, cwd=ROOT,
                              env={**os.environ, "USE_FLAX": "0"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        for line in proc.stdout.splitlines():
            d = json.loads(line)
            assert all(v <= limits[k] for k, v in d["checks"].items()), d
            assert any(v > limits[k] for k, v in d["control"].items()), d
