"""Codecs (``models/encodec.py``, ``models/vocos.py``, ``audio/trim.py``): the
``encode_reference``, ``vocode`` and ``trim`` stages of
``Mars5TTS.last_timing`` over the traced calls' seconds of audio. Source:
the program's stage spans."""

STAGES = ("encode_reference", "vocode", "trim")


def read(run):
    secs = sum(r["stages"].get(s, 0.0) for r in run["requests"] for s in STAGES)
    return 1e3 * secs / run["audio_s"] if run["audio_s"] else None
