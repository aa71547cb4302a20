"""Replicate/cog-style predictor of the port (counterpart of the root
``deploy/predict.py``): ``Predictor.setup()`` loads the model once,
``predict(text, ref_audio, ref_transcript, ...)`` writes a WAV and returns
its path. Needs no cog import, so it doubles as a server-side handler.

The deployment is configured by the environment, with the JAX predictor's
variables and defaults: ``MARS5_AR_CKPT``, ``MARS5_NAR_CKPT``,
``MARS5_ENCODEC_CKPT``, ``MARS5_VOCOS_CKPT``, ``MARS5_AR_BACKEND``
(``fused4``), ``MARS5_NAR_BACKEND`` (``int8``), ``MARS5_NAR_GEN_BUCKET`` (64),
``MARS5_NAR_TEXT_BUCKET`` (32) and ``MARS5_GUIDANCE_INTERVAL`` (``0,0.5``:
CFG on the low-noise half of the reverse steps). The JAX pipeline reads its
route switches from the environment where the port takes constructor
options; ``deploy_kwargs`` maps each switch the JAX package reads, with its
default and meaning there, onto the port's option, so one environment
selects one route in both packages. ``MARS5_GUIDANCE_INTERVAL`` is
validated: two floats with 0 <= lo < hi <= 1, else ValueError.

The models load in bf16: the int8 NAR's kernels K3/K4 take bf16
activations. The model runs on the card unless ``setup(device="cpu")``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch

DTYPE = torch.bfloat16


def _flag(environ, name: str, default: str) -> bool:
    return environ.get(name, default) == "1"


def guidance_interval(environ=os.environ) -> tuple:
    """``MARS5_GUIDANCE_INTERVAL`` (default ``0,0.5``) as (lo, hi)."""
    raw = environ.get("MARS5_GUIDANCE_INTERVAL", "0,0.5")
    try:
        gi = tuple(float(v) for v in raw.split(","))
    except ValueError:
        gi = ()
    if len(gi) != 2 or not 0.0 <= gi[0] < gi[1] <= 1.0:
        raise ValueError(f"MARS5_GUIDANCE_INTERVAL={raw!r}: expected two floats lo,hi with "
                         "0 <= lo < hi <= 1 (e.g. 0,0.5; 0,1 is the reference's CFG on "
                         "every step)")
    return gi


def deploy_kwargs(environ=os.environ) -> dict:
    """The ``Mars5TTS`` options a deployment's environment selects, each
    switch read with the JAX package's default and test:

    * ``MARS5_AR_BACKEND`` / ``MARS5_NAR_BACKEND`` / the buckets / the
      guidance interval: the JAX predictor's defaults;
    * ``MARS5_HEAD4=1`` -> ``head4`` (the int4 head; JAX reads it for an int4
      backbone only);
    * ``MARS5_INT4_MSE`` (default 1) -> ``int4_mse``;
    * ``MARS5_SDPA_BF16`` (default 1) -> ``nar_sdpa_bf16``;
    * ``MARS5_CROSS_PALLAS=1`` -> ``nar_cross_k1`` (the bf16 NAR's too);
    * for the int8 NAR only (the JAX switches act on quantized weights):
      ``MARS5_NAR_FUSED`` (default 1) -> ``nar_fused``, ``MARS5_NARF_SITES``
      (default ``qkv,caq,ffn``) -> ``nar_sites``, ``MARS5_NARF_GSIZE``
      (default 0; JAX groups only with the fused layer on) -> ``nar_gsize``,
      ``MARS5_QATTN=1`` -> ``nar_qattn``, ``MARS5_NAR_MEGA=1`` -> ``nar_mega``
      (not with group scales, which JAX's K9 refuses; its route runs every
      site, so the sites stay the default), ``MARS5_FUSED_TAIL=0`` ->
      ``nar_tail="dense"``, else ``MARS5_FUSED_HEADTAIL=0`` -> ``"split"``.
    """
    from ..models.layers import DEFAULT_OPTIONS, NAR_SITES

    ar_backend = environ.get("MARS5_AR_BACKEND", "fused4")
    nar_backend = environ.get("MARS5_NAR_BACKEND", "int8")
    kw = {"ar_backend": ar_backend, "nar_backend": nar_backend,
          "nar_gen_bucket": int(environ.get("MARS5_NAR_GEN_BUCKET", "64")),
          "nar_text_bucket": int(environ.get("MARS5_NAR_TEXT_BUCKET", "32")),
          "guidance_interval": guidance_interval(environ),
          "head4": ar_backend == "fused4" and _flag(environ, "MARS5_HEAD4", "0"),
          "int4_mse": _flag(environ, "MARS5_INT4_MSE", "1"),
          "nar_sdpa_bf16": _flag(environ, "MARS5_SDPA_BF16", "1"),
          "nar_cross_k1": _flag(environ, "MARS5_CROSS_PALLAS", "0"),
          "nar_mega": False}
    if nar_backend != "int8":
        return kw
    fused = _flag(environ, "MARS5_NAR_FUSED", "1")
    given = {s.strip() for s in environ.get("MARS5_NARF_SITES", "qkv,caq,ffn").split(",")
             if s.strip()}
    sites = tuple(s for s in NAR_SITES if s in given) + tuple(sorted(given - set(NAR_SITES)))
    gsize = int(environ.get("MARS5_NARF_GSIZE", "0")) if fused else 0
    mega = _flag(environ, "MARS5_NAR_MEGA", "0") and gsize == 0
    tail = ("dense" if not _flag(environ, "MARS5_FUSED_TAIL", "1")
            else "heads" if _flag(environ, "MARS5_FUSED_HEADTAIL", "1") else "split")
    kw.update(nar_fused=fused, nar_sites=DEFAULT_OPTIONS.sites if mega else sites,
              nar_gsize=gsize, nar_qattn=_flag(environ, "MARS5_QATTN", "0"),
              nar_mega=mega, nar_tail=tail)
    return kw


class Predictor:
    def setup(self, ar_path=None, nar_path=None, encodec_path=None, vocos_path=None,
              device=None):
        """Load the checkpoints (arguments, else the ``MARS5_*_CKPT``
        variables) with the environment's options (``deploy_kwargs``) onto
        ``device`` (default the card). ``MARS5_NAR_MEGA=1`` takes kernel K9
        where the decoder fits it (``mega_supported``), and the per-layer
        route otherwise, as the JAX package does."""
        from ..hub import load_codec_params
        from ..ops.kernels.nar_mega import mega_supported
        from ..pipeline import Mars5TTS

        ar_path = ar_path or os.environ.get("MARS5_AR_CKPT", "mars5_ar.safetensors")
        nar_path = nar_path or os.environ.get("MARS5_NAR_CKPT", "mars5_nar.safetensors")
        encodec_path = encodec_path or os.environ.get("MARS5_ENCODEC_CKPT")
        vocos_path = vocos_path or os.environ.get("MARS5_VOCOS_CKPT")
        kwargs = deploy_kwargs(os.environ)
        mega = kwargs.pop("nar_mega")
        codecs = {}
        if encodec_path:
            codecs["encodec_params"] = load_codec_params(encodec_path, "encodec")
        if vocos_path:
            codecs["vocos_params"] = load_codec_params(vocos_path, "vocos")
        model = Mars5TTS.from_local(ar_path, nar_path, device=device, dtype=DTYPE,
                                    **codecs, **kwargs)
        if mega and mega_supported(model.codecnar.tfm.decoder):
            model = Mars5TTS.from_params(model.codeclm, model.codecnar,
                                         texttok=model.texttok, speechtok=model.speechtok,
                                         encodec=model.encodec, vocos=model.vocos,
                                         nar_mega=True, **kwargs)
        self.model = model

    def predict(self, text: str, ref_audio: str, ref_transcript: str,
                top_k: int = 100, temperature: float = 0.7,
                freq_penalty: float = 3.0, rep_penalty_window: int = 100,
                out_path: str | None = None) -> str:
        """Synthesize ``text`` cloned from ``ref_audio`` (a WAV path) with the
        reference deployment's deep-clone configuration; returns the written
        WAV's path (a new temporary file unless ``out_path``)."""
        from ..audio.io import read_wav, write_wav
        from ..config import InferenceConfig

        audio_in, _ = read_wav(ref_audio, target_sr=24000)
        cfg = InferenceConfig(deep_clone=True, rep_penalty_window=rep_penalty_window,
                              top_k=top_k, temperature=temperature,
                              freq_penalty=freq_penalty)
        _, wav = self.model.tts(text, audio_in, ref_transcript=ref_transcript, cfg=cfg)
        if out_path is None:
            out_path = str(Path(tempfile.mkdtemp()) / "output.wav")
        write_wav(out_path, wav, sr=self.model.sr)
        return out_path
