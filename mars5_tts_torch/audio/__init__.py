"""Host-side audio DSP (the port's own copy of ``mars5_tts_tpu/audio/trim.py``)."""
