"""The plain PyTorch reference of the MARS5 synthesis path that decides
``correct``. It imports nothing of ``mars5_tts_torch``: it reads the state
dicts the benchmark draws from the seed (``portbench/weights.py``), works
out again every quantity the port's set-up derives from them (the W4A8 AR
pack with its int4 clip search, the W8A8 NAR, the folded heads), and runs in
float32 with TF32 off. Each copy of the port's arithmetic names the file and
lines it came from.
"""
