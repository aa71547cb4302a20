"""``mars5_tts_torch/graft_entry.py`` (the counterpart of the repo root's
``__graft_entry__.py``) and the script counterparts
``mars5_tts_torch/tools/e2e_tiny.py`` and ``tools/train_tiny.py``, on the
CPU: gloo processes stand for the JAX dry run's virtual devices."""

import re

import pytest
import torch


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (1, 4)),
                                    (6, (3, 2)), (8, (2, 4))])
def test_mesh_shape_is_the_jax_dry_runs(n, want):
    """tp = 4 when 4 divides the ranks, else 2 when 2 does, else 1
    (``__graft_entry__.dryrun_multichip``)."""
    from mars5_tts_torch.graft_entry import mesh_shape

    assert mesh_shape(n) == want


def test_dryrun_multichip_4(capsys):
    """Four gloo ranks, dp 1 x tp 4: one train step with finite losses,
    the data-parallel AR decode and NAR grid bitwise one process's, the
    tensor-parallel ones equal to one process's, the per-rank parameter
    bytes of the MARS5-geometry AR; one OK line."""
    from mars5_tts_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh dp=1 tp=4, ar_loss=")
    assert "tp=4 AR decode and NAR grid equal to one process's" in line
    gib = [float(x) for x in re.findall(r"([\d.]+) GiB", line)]
    assert len(gib) == 2 and 0 < gib[0] < gib[1] / 2


def test_rank_parameter_bytes_of_the_mars5_ar():
    """The MARS5-geometry bf16 AR on the meta device: its bytes whole (2 a
    parameter), and a rank's at tp 2 and 4: every sharded weight split
    evenly (24 heads, FFN 3584, vocabulary 24,000), the rest replicated."""
    from mars5_tts_torch.graft_entry import rank_parameter_bytes
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.parallel import codeclm_specs

    with torch.device("meta"):
        ar = CodecLM(CodecLMConfig.mars5(n_vocab=24_000))
    total = sum(p.numel() for p in ar.parameters())
    sharded = sum(p.numel() for n, p in ar.named_parameters()
                  if not codeclm_specs(ar, 2)[n].is_replicate())
    assert rank_parameter_bytes(1) == 2 * total
    for tp in (2, 4):
        assert rank_parameter_bytes(tp) == 2 * (total - sharded + sharded // tp)


def test_entry_on_the_cpu(monkeypatch):
    """``entry(device="cpu")``: the released widths (dim 1536, 24 heads,
    vocabulary 24,000) in bf16, its depth cut to two layers here by a
    patched ``CodecLMConfig.mars5`` (the CPU tests keep full-size models
    out; the 26 layers run on the card, ``tests/test_torch_cuda.py``), give
    finite (1, 64, 24,000) logits from (1, 64) tokens and (1, 75, 8) codes."""
    import dataclasses

    from mars5_tts_torch.graft_entry import entry
    from mars5_tts_torch.models.ar import CodecLMConfig

    released = CodecLMConfig.mars5
    monkeypatch.setattr(CodecLMConfig, "mars5", classmethod(
        lambda cls, n_vocab: dataclasses.replace(released(n_vocab), n_layers=2)))
    fn, args = entry(device="cpu")
    model, tokens, spk = args
    assert model.cfg.dim == 1536 and model.cfg.n_heads == 24 and model.cfg.n_layers == 2
    assert model.embed.weight.dtype == torch.bfloat16 and not model.embed.weight.is_cuda
    assert tokens.shape == (1, 64) and spk.shape == (1, 75, 8)
    out = fn(*args)
    assert out.shape == (1, 64, 24_000) and bool(torch.isfinite(out).all())


def test_e2e_tiny_main(capsys):
    """``tools/e2e_tiny.py``: the public API on seeded tiny models, a
    shallow and a deep clone, finite audio, the stage times printed."""
    from mars5_tts_torch.tools import e2e_tiny

    assert e2e_tiny.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^shallow: \d+ AR codes, \d+ samples", out, re.M)
    assert re.search(r"^deep: \d+ AR codes, \d+ samples", out, re.M)
    assert "ar_generate" in out and "nar_diffusion" in out and out.strip().endswith("OK")


def test_train_tiny_main(tmp_path, capsys):
    """``tools/train_tiny.py``: four gloo ranks (dp 2 x tp 2), six steps on
    ``synthetic_corpus`` batches, the AR loss falling, both models saved
    in the reference's ``.pt`` layout, which the port's loaders read back
    at the trained config."""
    from mars5_tts_torch.hub import load_checkpoint
    from mars5_tts_torch.models.ar import CodecLMConfig
    from mars5_tts_torch.models.convert import load_codeclm, load_nar
    from mars5_tts_torch.models.nar import ResidualTransformerConfig
    from mars5_tts_torch.tools import train_tiny

    assert train_tiny.main(["--device", "cpu", "--steps", "6", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mesh dp=2 tp=2" in out and "6 steps in" in out
    for name, cfg_cls, load in (("ar", CodecLMConfig, load_codeclm),
                                ("nar", ResidualTransformerConfig, load_nar)):
        ckpt = load_checkpoint(tmp_path / f"mars5_{name}_tiny.pt")
        cfg = cfg_cls(**ckpt["config"])
        model = load(ckpt["model"], cfg)           # strict: every key, every shape
        assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert cfg.n_text_vocab == train_tiny.N_TEXT
