"""Host-side audio: silence trim and WAV I/O (the port's own copies of
``mars5_tts_tpu/audio/trim.py`` and ``mars5_tts_tpu/audio/io.py``)."""
