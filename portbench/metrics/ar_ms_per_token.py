"""AR decode (``models/ar_decode_fused.py``, the prefill in ``models/ar_decode.py``):
the ``ar_generate`` stage of ``Mars5TTS.last_timing`` over the decode steps
of the traced calls, prefill included (a batched call's step makes a token
for each of its rows: its steps are its longest row's tokens). Source: the
program's stage spans."""


def read(run):
    secs = sum(r["stages"].get("ar_generate", 0.0) for r in run["requests"])
    steps = sum(max(n for _, n in r["ar"]) for r in run["requests"] if r["ar"])
    return 1e3 * secs / steps if steps else None
