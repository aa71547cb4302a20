"""MARS5-TTS in PyTorch for NVIDIA GPUs: the port of ``mars5_tts_tpu``.

Same synthesis (Encodec encode, AR codec LM, CFG multinomial-diffusion NAR,
Vocos vocode) with ``nn.Module`` models, explicit devices and explicit
``torch.Generator`` randomness. The JAX package stays the reference; this
package imports nothing of it.
"""

from .config import DSH, InferenceConfig

__all__ = ["DSH", "InferenceConfig", "Mars5TTS"]


def __getattr__(name):
    if name == "Mars5TTS":
        from .pipeline import Mars5TTS
        return Mars5TTS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
