"""torch.hub-style entry point of the port (counterpart of the root
``hubconf.py``, which ``torch.hub.load`` finds and which loads the JAX
package):

    from mars5_tts_torch.hubconf import mars5_english
    mars5, config_class = mars5_english(ar_path="mars5_ar.safetensors",
                                        nar_path="mars5_nar.safetensors")

Without explicit paths the reference release checkpoints are downloaded from
the pinned URLs below into ``MARS5_CACHE`` (default
``~/.cache/mars5_tts_torch``).
"""

import logging
import os
from pathlib import Path

dependencies = ["torch", "numpy"]

# the pinned reference release (the root hubconf.py's URLs)
AR_CKPT_URL = ("https://github.com/Camb-ai/MARS5-TTS/releases/download/"
               "v0.3/mars5_en_checkpoints_ar-3000000.safetensors")
NAR_CKPT_URL = ("https://github.com/Camb-ai/MARS5-TTS/releases/download/"
                "v0.3/mars5_en_checkpoints_nar-1980000.safetensors")


def _download(url: str, dest: Path, progress: bool = True) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists():
        return dest
    import urllib.request
    logging.info("downloading %s -> %s", url, dest)
    urllib.request.urlretrieve(url, dest)  # noqa: S310
    return dest


def mars5_english(pretrained: bool = True, progress: bool = True, device=None,
                  ckpt_format: str = "safetensors", ar_path=None, nar_path=None,
                  **kwargs):
    """Load the MARS5 English model -> (Mars5TTS, InferenceConfig class),
    with the reference signature. ``device`` is where the model runs
    (default the card; ``"cpu"`` to run there); ``kwargs`` go to
    ``Mars5TTS.from_local``. ``ckpt_format`` must be ``safetensors`` or
    ``pt``; the download is the safetensors release either way."""
    from mars5_tts_torch.config import InferenceConfig
    from mars5_tts_torch.pipeline import Mars5TTS

    if ckpt_format not in ("safetensors", "pt"):
        raise ValueError(f"ckpt_format must be 'safetensors' or 'pt', got {ckpt_format!r}")
    cache = Path(os.environ.get("MARS5_CACHE", "~/.cache/mars5_tts_torch")).expanduser()
    if ar_path is None:
        ar_path = _download(AR_CKPT_URL, cache / "mars5_ar.safetensors", progress)
    if nar_path is None:
        nar_path = _download(NAR_CKPT_URL, cache / "mars5_nar.safetensors", progress)
    model = Mars5TTS.from_local(ar_path, nar_path, device=device, **kwargs)
    return model, InferenceConfig
