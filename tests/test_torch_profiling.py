"""The spans of ``mars5_tts_torch`` (``utils/profiling.span``) in a
``torch.profiler`` trace of ``Mars5TTS.tts`` and ``.tts_batch`` at the tiny
geometry on the CPU: one ``mars5.request`` a call, one ``mars5.stage.<name>``
a stage of ``last_timing``, one ``mars5.ar.step`` a decode step and one
``mars5.nar.step`` a reverse step, each span nested where it belongs; with the
profiler off the spans are one shared null context and the outputs are those
of a traced call. Also ``last_timing["grid_audio_s"]``, the served grid's
seconds before the trim."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import (make_tokenizers, port_codeclm, port_nar,  # noqa: E402
                                       tiny_models)

HOP = 16                 # the tiny Vocos' hop (tests/torch_port_fixtures.py)

# each span's innermost enclosing span
PARENTS = {
    "mars5.request": {None},
    "mars5.ar.prefill": {"mars5.stage.ar_generate"},
    "mars5.ar.step": {"mars5.stage.ar_generate"},
    "mars5.ar.forward": {"mars5.ar.step"},
    "mars5.ar.sample": {"mars5.ar.step", "mars5.ar.prefill"},
    "mars5.ar.readback": {"mars5.ar.step", "mars5.ar.prefill"},
    "mars5.nar.memory": {"mars5.stage.nar_diffusion"},
    "mars5.nar.step": {"mars5.stage.nar_diffusion"},
    "mars5.nar.decoder": {"mars5.nar.step"},
    "mars5.nar.tail": {"mars5.nar.step"},
}


def _tts(**kw):
    from mars5_tts_torch import Mars5TTS
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_torch.models.vocos import vocos_from_pytree

    cfgs, tiny = tiny_models()
    texttok, speechtok, _, _ = make_tokenizers()
    return Mars5TTS.from_params(port_codeclm(cfgs["ar"], tiny["ar"]),
                                port_nar(cfgs["nar"], tiny["nar"]),
                                texttok=texttok, speechtok=speechtok,
                                encodec=encodec_from_pytree(tiny["encodec"]),
                                vocos=vocos_from_pytree(tiny["vocos"]), **kw)


def _ref(n, seed=10):
    return (np.random.default_rng(seed + n).standard_normal(n) * 0.1).astype(np.float32)


def _cfg(**kw):
    from mars5_tts_torch import InferenceConfig

    return InferenceConfig(timesteps=5, generate_max_len_override=120, trim_db=200, **kw)


def _traced(fn):
    """``fn()`` under a CPU ``torch.profiler``; returns (its result, the
    ``mars5.*`` spans as (name, start_ns, end_ns, thread) sorted by start)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("mars5.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span's name (None at the top)."""
    out = []
    for i, (name, a, b, th) in enumerate(spans):
        around = [s for j, s in enumerate(spans)
                  if j != i and s[3] == th and s[1] <= a and b <= s[2]]
        out.append((name, min(around, key=lambda s: s[2] - s[1])[0] if around else None))
    return out


def _count(spans, name):
    return sum(s[0] == name for s in spans)


def _decode_steps(monkeypatch):
    """The ``DecodeState`` of every decode loop run from now on; each one's
    ``steps`` counts its decode steps."""
    from mars5_tts_torch.models import ar_decode

    states, loop = [], ar_decode.decode_loop

    def run(state, *a, **kw):
        states.append(state)
        return loop(state, *a, **kw)

    monkeypatch.setattr(ar_decode, "decode_loop", run)
    return states


def _check_spans(spans, tts, steps, T):
    assert _count(spans, "mars5.request") == 1
    stages = {s[0] for s in spans if s[0].startswith("mars5.stage.")}
    assert stages == {"mars5.stage." + k for k in tts.last_timing["stages_s"]}
    assert all(_count(spans, name) == 1 for name in stages)
    assert _count(spans, "mars5.ar.step") == steps > 0
    assert _count(spans, "mars5.ar.prefill") == 1
    for name in ("mars5.ar.forward", "mars5.ar.sample", "mars5.ar.readback"):
        assert _count(spans, name) == steps + (name != "mars5.ar.forward")
    assert _count(spans, "mars5.nar.step") == T
    assert _count(spans, "mars5.nar.memory") == 1
    for name, parent in _parents(spans):
        want = PARENTS.get(name, {"mars5.request"})
        assert parent in want, (name, parent)


@pytest.mark.parametrize("nar_backend", ["bf16", "int8"])
def test_tts_spans_nest_in_their_step_stage_and_request(monkeypatch, nar_backend):
    tts = _tts(nar_backend=nar_backend)
    states = _decode_steps(monkeypatch)
    (codes, audio), spans = _traced(lambda: tts.tts("hi there", _ref(8 * 56),
                                                    ref_transcript="ok", cfg=_cfg(), seed=3))
    assert len(states) == 1
    _check_spans(spans, tts, states[0].steps, 5)


def test_tts_batch_spans_nest_in_their_step_stage_and_request(monkeypatch):
    tts = _tts()
    states = _decode_steps(monkeypatch)
    outs, spans = _traced(lambda: tts.tts_batch(
        ["hi there", "a longer line", "yo"], [_ref(8 * 56), _ref(8 * 40), _ref(8 * 48)],
        ref_transcript=["ok", "fine", "sure"], cfg=_cfg(), seed=2))
    assert len(outs) == 3 and len(states) == 1
    _check_spans(spans, tts, states[0].steps, 5)


def test_span_off_is_the_shared_null_context(monkeypatch):
    from mars5_tts_torch.utils import profiling

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler running")

    monkeypatch.setattr(profiling, "host_range", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("ar.step") is profiling.span("nar.step") is profiling._NULL
    timer = profiling.StageTimer()
    with timer.stage("a"), profiling.span("ar.step"):
        pass
    assert set(timer.stages) == {"a"}
    tts = _tts()
    codes, audio = tts.tts("hi there", _ref(8 * 56), ref_transcript="ok", cfg=_cfg(), seed=3)
    assert len(codes) and np.isfinite(audio).all()


@pytest.mark.parametrize("entry", ["tts", "tts_batch"])
def test_traced_call_is_bitwise_the_untraced_one(entry):
    tts = _tts(nar_backend="int8")
    if entry == "tts":
        def call():
            return [tts.tts("hi there", _ref(8 * 56), ref_transcript="ok", cfg=_cfg(), seed=4)]
    else:
        def call():
            return tts.tts_batch(["hi there", "yo"], [_ref(8 * 56), _ref(8 * 40)],
                                 ref_transcript=["ok", "fine"], cfg=_cfg(), seed=4)
    plain = call()
    traced, spans = _traced(call)
    assert _count(spans, "mars5.request") == 1
    for (c0, w0), (c1, w1) in zip(plain, traced, strict=True):
        np.testing.assert_array_equal(c1, c0)
        np.testing.assert_array_equal(w1, w0)


@pytest.mark.parametrize("deep_clone", [True, False])
def test_grid_audio_s_is_the_served_grid_before_the_trim(monkeypatch, deep_clone):
    from mars5_tts_torch import pipeline

    tts = _tts()
    refs = [_ref(8 * 56), _ref(8 * 40)]
    cfg = _cfg(deep_clone=deep_clone)
    codes, audio = tts.tts("hi there", refs[0], ref_transcript="ok", cfg=cfg, seed=5)
    t = tts.last_timing
    assert t["grid_audio_s"] == len(tts.last_grid) * HOP / 24000 > 0
    if not deep_clone:           # the served grid is the AR's frames
        assert t["grid_audio_s"] == len(codes) * HOP / 24000
    assert t["audio_s"] == len(audio) / 24000
    # a trim that halves the audio leaves the grid's count as it was
    monkeypatch.setattr(pipeline, "trim", lambda a, top_db: (a[: len(a) // 2], None))
    tts.tts("hi there", refs[0], ref_transcript="ok", cfg=cfg, seed=5)
    assert tts.last_timing["grid_audio_s"] == t["grid_audio_s"]
    assert tts.last_timing["audio_s"] == len(audio) // 2 / 24000

    outs = tts.tts_batch(["hi there", "yo"], refs, ref_transcript=["ok", "fine"], cfg=cfg,
                         seed=5)
    skips = [tts.encode_reference(r).shape[-1] if deep_clone else 0 for r in refs]
    frames = sum(max(len(c) - s, 0) for (c, _), s in zip(outs, skips))
    assert tts.last_timing["grid_audio_s"] == frames * HOP / 24000 > 0
    assert tts.last_timing["audio_s"] == sum(len(w) for _, w in outs) / 24000
