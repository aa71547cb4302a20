"""``mars5_tts_torch/tools/profile_ar.py`` and ``profile_nar.py`` run end to
end on the CPU at a tiny width (their ``--device cpu`` dry runs) and print
the keys PERF.md reads."""

import json
import runpy
import sys

import pytest
import torch

ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.mark.parametrize("engine", ["fused4-head4", "bf16"])
def test_profile_ar_dry_run(engine, monkeypatch, capsys):
    from mars5_tts_torch.models import ar

    tiny = ar.CodecLMConfig(n_vocab=1400, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            n_layers=1, hidden_dim=512, sliding_window=3000, n_spk_layers=1,
                            spk_hidden_dim=256)
    monkeypatch.setattr(ar.CodecLMConfig, "mars5", staticmethod(lambda n_vocab: tiny))
    monkeypatch.setattr(sys, "argv", ["profile_ar.py", "--device", "cpu", "--engine", engine,
                                      "--tokens", "2", "--repeat", "1", "--root", ROOT])
    torch.manual_seed(0)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_ar.py", run_name="__main__")
    assert done.value.code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == engine and out["tokens"] == 2
    for key in ("wall_ms_per_token", "wall_ms_per_token_after_profiler",
                "device_ms_per_token", "stream_syncs_per_token", "top_host_ops_us_per_token"):
        assert key in out
    assert ("k2_device_ms" in out) == (engine != "bf16")


@pytest.mark.parametrize("nar", ["int8", "bf16"])
def test_profile_nar_dry_run(nar, monkeypatch, capsys):
    from mars5_tts_torch.models import nar as nar_mod

    monkeypatch.setattr(nar_mod.ResidualTransformerConfig, "mars5",
                        staticmethod(lambda n_text_vocab: nar_mod.ResidualTransformerConfig.tiny()))
    monkeypatch.setattr(sys, "argv", ["profile_nar.py", "--device", "cpu", "--nar", nar,
                                      "--prompt", "8", "--gen", "4", "--steps", "2",
                                      "--repeat", "1", "--profile-steps", "1", "--root", ROOT])
    torch.manual_seed(0)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_nar.py", run_name="__main__")
    assert done.value.code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nar"] == nar and out["frames"] == 12 and out["steps"] == 2
    assert out["profile_steps"] == 1
    for key in ("wall_ms_per_step", "wall_ms_per_step_runs", "device_ms_per_step",
                "device_idle_share", "k1_device_ms_per_step", "launches_per_step",
                "stream_syncs_per_step", "top_host_ops_us_per_step"):
        assert key in out
