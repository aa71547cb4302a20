"""The port's CLI (``python -m mars5_tts_torch.cli``) at tiny geometry, on
files the port wrote (``tests/torch_port_fixtures.write_port_files``), with
``--device cpu``.

* ``build_parser`` accepts and rejects the argv cases the JAX CLI's does,
  with the same values (``--device`` in place of ``--platform``).
* Plain synthesis: the WAV's PCM equals ``float_to_pcm16`` of
  ``Mars5TTS.from_local(...).tts`` on the same files and seed, sample for
  sample; ``--timings`` prints ``last_timing``.
* ``--stream``'s incrementally written WAV equals ``--longform``'s, byte for
  byte (as the JAX ``tests/test_cli.py``); ``--progressive`` writes every
  segment and reports the time to the first audio.
* The card is the default: without one, the CLI raises before loading,
  with no ``--device`` and with ``--device cuda``.
"""

import json
import wave

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import write_port_files  # noqa: E402

BASE = ["--text", "t", "--ref", "r.wav", "--ar", "a", "--nar", "n"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_port_files(tmp_path_factory.mktemp("cli"))


def _args(files, out, *extra, text="hi there. ok then."):
    return ["--text", text, "--ref", files["ref"], "--ar", files["ar"], "--nar", files["nar"],
            "--encodec", files["encodec"], "--vocos", files["vocos"], "--timesteps", "6",
            "--max-len", "240", "--trim-db", "200", "--seed", "3", "--out", str(out),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra", [
    [], ["--max-chars", "1"], ["--max-chars", "0"], ["--max-chars", "-3"],
    ["--first-chunk-chars", "0"], ["--first-chunk-timesteps", "0"], ["--seg-frames", "0"],
    ["--stream", "--longform"], ["--progressive", "--stream"], ["--progressive", "--longform"],
    ["--ctx-frames", "-5", "--progressive"], ["--shallow", "--timings", "--top-k", "50"],
    ["--temperature", "x"], ["--stream", "--first-chunk-chars", "80",
                             "--first-chunk-timesteps", "100"]])
def test_parser_accepts_and_rejects_as_jax(extra):
    from mars5_tts_tpu.cli import build_parser as j_parser
    from mars5_tts_torch.cli import build_parser as p_parser

    def parse(parser):
        try:
            return vars(parser().parse_args(BASE + extra))
        except SystemExit:
            return None

    got, want = parse(p_parser), parse(j_parser)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.pop("device") is None and want.pop("platform") is None
        assert got == want
    with pytest.raises(SystemExit):
        p_parser().parse_args(BASE[2:] + extra)              # --text is required


def _pcm(path):
    with wave.open(str(path), "rb") as w:
        assert w.getframerate() == 24000 and w.getsampwidth() == 2 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_plain_pcm_equals_in_process_tts(files, tmp_path, capsys):
    from mars5_tts_torch import InferenceConfig, Mars5TTS
    from mars5_tts_torch.audio.io import float_to_pcm16, read_wav
    from mars5_tts_torch.cli import main
    from mars5_tts_torch.hub import load_codec_params

    out = tmp_path / "plain.wav"
    assert main(_args(files, out, "--transcript", "ok", "--timings")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith(f"wrote {out}")
    assert set(json.loads(lines[-1])["stages_s"]) >= {"ar_generate", "nar_diffusion", "vocode"}
    tts = Mars5TTS.from_local(files["ar"], files["nar"], device="cpu",
                              encodec_params=load_codec_params(files["encodec"], "encodec"),
                              vocos_params=load_codec_params(files["vocos"], "vocos"))
    cfg = InferenceConfig(timesteps=6, generate_max_len_override=240, trim_db=200)
    _, audio = tts.tts("hi there. ok then.", read_wav(files["ref"], 24000)[0],
                       ref_transcript="ok", cfg=cfg, seed=3)
    got = _pcm(out)
    assert len(got) > 0
    np.testing.assert_array_equal(got, float_to_pcm16(audio))


def test_stream_bytes_equal_longform_bytes(files, tmp_path, capsys):
    from mars5_tts_torch.cli import main

    batch, stream = tmp_path / "batch.wav", tmp_path / "stream.wav"
    assert main(_args(files, batch, "--shallow", "--longform", "--max-chars", "10")) == 0
    assert main(_args(files, stream, "--shallow", "--stream", "--max-chars", "10")) == 0
    out = capsys.readouterr().out
    assert "time-to-first-audio" in out and "chunk 1:" in out and "[final]" in out
    assert batch.read_bytes() == stream.read_bytes()


def test_progressive_writes_every_segment(files, tmp_path, capsys):
    """The WAV is every ``stream_tts`` segment's PCM in order (the same run
    in process), with a line a segment and one time to first audio."""
    from mars5_tts_torch import InferenceConfig, Mars5TTS
    from mars5_tts_torch.audio.io import float_to_pcm16, read_wav
    from mars5_tts_torch.cli import main
    from mars5_tts_torch.hub import load_codec_params
    from mars5_tts_torch.serving import stream_tts

    out = tmp_path / "prog.wav"
    assert main(_args(files, out, "--shallow", "--progressive", "--seg-frames", "8",
                      "--ctx-frames", "8", "--timings")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(ln.startswith("time-to-first-audio") for ln in lines) == 1
    segs = [ln for ln in lines if ln.startswith("segment ")]
    assert len(segs) >= 2 and segs[0].startswith("segment 0: frames [0,8) +")
    timings = json.loads(lines[-1])
    assert len(timings) == len(segs) and sum("ttfa_s" in t for t in timings) == 1
    assert lines[-2].startswith(f"wrote {out}")
    tts = Mars5TTS.from_local(files["ar"], files["nar"], device="cpu",
                              encodec_params=load_codec_params(files["encodec"], "encodec"),
                              vocos_params=load_codec_params(files["vocos"], "vocos"))
    cfg = InferenceConfig(deep_clone=False, timesteps=6, generate_max_len_override=240,
                          trim_db=200)
    chunks = list(stream_tts(tts, "hi there. ok then.", read_wav(files["ref"], 24000)[0],
                             ref_transcript="", cfg=cfg, seed=3, seg_frames=8, ctx_frames=8))
    assert len(chunks) == len(segs)
    np.testing.assert_array_equal(_pcm(out),
                                  np.concatenate([float_to_pcm16(c.pcm) for c in chunks]))


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_card_raises_before_loading(files, tmp_path, monkeypatch, device):
    from mars5_tts_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(files, tmp_path / "x.wav") if a not in ("--device", "cpu")]
    if device:
        args += ["--device", device]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    assert not (tmp_path / "x.wav").exists()
