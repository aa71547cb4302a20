"""The benchmark of ``mars5_tts_torch`` on one NVIDIA H100 (see README.md)."""
