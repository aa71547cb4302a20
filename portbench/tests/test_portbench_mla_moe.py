"""The bf16 AR route's reference (``reference/ar_bf16.py``) for both blocks it
serves, the DeepSeek-V2 block's (``reference/mla_moe.py``) against a tiny
program, the ``mars5-dsv2lite`` cell at a tiny DeepSeek-V2 geometry, and the
reader of ``roofline.K10`` on a synthetic run."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, run, weights
from portbench.work_moe import k10_call, k10_step_bound_s
from tiny import TINY, shrink

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977
TINY_MLA = {"n_vocab": 1400, "dim": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 48,
            "n_layers": 3, "hidden_dim": 256, "sliding_window": 4096, "norm_eps": 1e-06,
            "n_spk_layers": 1, "spk_hidden_dim": 192, "codebook_size": 1025, "n_codebooks": 8,
            "attention": "mla", "kv_lora_rank": 64,
            "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32, "rope_factor": 40.0,
            "rope_original_max_pos": 4096, "rope_beta_fast": 32.0, "rope_beta_slow": 1.0,
            "rope_mscale": 0.707, "rope_mscale_all_dim": 0.707, "n_routed_experts": 8,
            "n_shared_experts": 2, "n_experts_per_tok": 2, "moe_hidden_dim": 64,
            "first_k_dense": 1, "routed_scaling_factor": 1.0}


def _route():
    return check._route("ar", "bf16")


def _program(ar_cfg, seed=3):
    """The port's AR at ``ar_cfg`` holding the seed's weights, in float32, and
    the weights the reference reads."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig

    sd = weights.make_state("ar", {"ar": ar_cfg}, seed, "cpu", torch.float32)
    m = CodecLM(CodecLMConfig(**ar_cfg)).eval()
    m.load_state_dict(sd)
    return m, sd


def _request(seed=4, n_prompt=20, n_served=12):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 258, n_prompt)),
            torch.as_tensor(rng.integers(0, 1024, (25, 8))),
            torch.as_tensor(rng.integers(258, 258 + 1025, n_served)))


@pytest.mark.parametrize("ar_cfg", [TINY["ar"], TINY_MLA], ids=["mars5", "dsv2"])
@torch.no_grad()
def test_served_logits_are_the_programs_teacher_forced_logits(ar_cfg):
    """The route's reference logits of each served token against the
    program's own forward over the prompt and the served tokens (f32 against
    f32: sums in other orders, ~1e-6 of the logits' scale), and its control
    (float8 GEMM operands) well away from them."""
    m, sd = _program(ar_cfg)
    prompt, spk, served = _request()
    mod = _route()
    want = mod.served_logits(mod.prepare(sd, ar_cfg, {}), ar_cfg, prompt, spk, served)
    toks = torch.cat([prompt, served[:-1]])[None]
    got = m.prefill(toks, m.spk_embedding(spk[None]))[0][0, len(prompt):]
    scale = float(want.abs().max())
    assert want.shape == (len(served), ar_cfg["n_vocab"])
    assert float((got - want).abs().max()) <= 2e-5 * scale
    ctl = mod.served_logits(mod.prepare(sd, ar_cfg, {}, control=True), ar_cfg, prompt, spk,
                            served)
    assert float((ctl - want).abs().max()) >= 1e-2 * scale


@torch.no_grad()
def test_mla_moe_reference_decodes_as_the_program():
    """``reference/mla_moe.py`` against the program's decode through its
    latent ring and K10's twin, token by token."""
    from mars5_tts_torch.models import ar_decode as AD

    from portbench.reference import mla_moe
    from portbench.reference.ar import spk_vector

    m, sd = _program(TINY_MLA)
    prompt, spk, served = _request()
    x = torch.cat([spk_vector(sd, spk, TINY_MLA)[None], sd["embed.weight"][prompt],
                   sd["embed.weight"][served[:-1]]])
    want = mla_moe.logits(sd, TINY_MLA, x)[len(prompt):]
    first, states = AD.prefill_rows(m, [prompt.numpy()], [spk.numpy()], 4096)
    cache = AD.make_cache(m.cfg, 1, 64, torch.float32, "cpu")
    cache.write_prompt(0, states[0])
    got = [first[0]] + [AD.decode_step(m, served[i:i + 1].numpy(),
                                       np.array([len(prompt) + 1 + i]), cache)[0]
                        for i in range(len(served) - 1)]
    assert float((torch.stack(got) - want).abs().max()) <= 2e-5 * float(want.abs().max())


def test_dsv2lite_cell_runs_at_a_tiny_deepseek_geometry():
    """The cell with its AR a tiny DeepSeek-V2 block (the tiny geometry
    elsewhere): the program serves it on the bf16 route and the reference
    judges it; the traced run's line carries no ``roofline.K10`` on the CPU
    (no device trace), and ``ar_miss`` reads a number."""
    def override(spec):
        shrink(spec)
        spec["config"]["ar"] = dict(TINY_MLA)

    out = run.run_cell("dsv2lite.shallow-long", SEED, 0.0, True, device="cpu",
                       override=override)
    assert out["failed"] == 0 and out["attempted"] == 2
    assert "roofline.K10" not in out["metrics"]
    assert out["checks"]["ar_miss"]["value"] is not None
    assert out["checks"]["ar_miss"]["value"] <= out["checks"]["ar_miss"]["limit"]


def _reader():
    path = ROOT / "portbench" / "metrics" / "roofline.K10.py"
    spec = importlib.util.spec_from_file_location("roofline_k10", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(ops, ar_rows, ar_cfg):
    return {"trace": {"breakdown": {"device_ops": ops, "idle_gaps": []}},
            "requests": [{"ar": rows} for rows in ar_rows], "config": {"ar": ar_cfg}}


def test_roofline_k10_reader_on_a_synthetic_run():
    ar = json.loads((ROOT / "portbench" / "configs" / "mars5-dsv2lite.json").read_text())["ar"]
    read = _reader()
    ops = [["moe_decode_up((anonymous namespace)::Args)", 0.8],
           ["ampere_bf16_s16816gemm", 0.5], ["moe_decode_down((anonymous namespace)::Args)", 0.3]]
    rows = [[(np.zeros(700), 600)], [(np.zeros(1500), 1300)]]
    want = 100.0 * (599 + 1299) * k10_step_bound_s(ar) / 1.1
    assert read(_run(ops, rows, ar)) == pytest.approx(want, rel=1e-12)
    # one step of one row: 13 expert layers of 138.4 MB at 3.35 TB/s
    nb, _ = k10_call(2048, 1408, 6, 2816, 1, 6)
    assert k10_step_bound_s(ar) == pytest.approx(13 * nb / 3.35e12, rel=1e-12)
    assert 138.4e6 < nb < 138.5e6
    assert read(_run(ops[:2], rows, ar)) is None                   # a kernel missing
    assert read(_run(ops, [[(np.zeros(9), 5), (np.zeros(9), 5)]], ar)) is None   # two rows
    assert read(_run(ops, rows, dict(ar, n_routed_experts=0))) is None
    assert read({"trace": None, "requests": [], "config": {"ar": ar}}) is None
