"""NAR diffusion (``diffusion/engine.py``, ``models/nar.py``, ``models/layers.py``,
``ops/quant.py``): the ``nar_diffusion`` stage of ``Mars5TTS.last_timing``
over the reverse steps of the traced calls. Source: the program's stage
spans."""


def read(run):
    secs = sum(r["stages"].get("nar_diffusion", 0.0) for r in run["requests"])
    steps = sum(r["nar"]["T"] for r in run["requests"] if r["nar"] is not None)
    return 1e3 * secs / steps if steps else None
