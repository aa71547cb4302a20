"""Checkpoint loading: the reference's dual .pt / .safetensors format.

* ``.safetensors``: model tensors as keys; both BPE tokenizer model files embedded
  as UTF-8 strings in the file *metadata* under ``texttok.model`` /
  ``speechtok.model`` (and an optional ``mars5_config`` JSON).
* ``.pt``: a dict with ``'vocab'`` and ``'model'`` keys.

The port's own copy of ``load_checkpoint`` and ``load_tokenizers`` from
``mars5_tts_tpu/hub.py``; tensors come back as numpy arrays.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np

from .text import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer


def load_checkpoint(path) -> dict:
    """Load a MARS5 AR/NAR checkpoint (.safetensors or .pt) -> {'vocab', 'model'}."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors import safe_open

        ckpt = {"vocab": {}, "model": {}}
        with safe_open(str(path), framework="np") as f:
            metadata = f.metadata() or {}
            for key in ("texttok.model", "speechtok.model"):
                if key in metadata:
                    ckpt["vocab"][key] = metadata[key]
            if "mars5_config" in metadata:
                ckpt["config"] = json.loads(metadata["mars5_config"])
            for k in f.keys():
                ckpt["model"][k] = f.get_tensor(k)
        return ckpt
    if path.suffix in (".pt", ".pth", ".bin", ".th"):
        import torch

        raw = torch.load(str(path), map_location="cpu", weights_only=False)
        model = raw.get("model", raw)
        vocab = raw.get("vocab", {})
        return {"vocab": vocab,
                "model": {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
                          for k, v in model.items()}}
    raise ValueError(f"unsupported checkpoint format: {path.suffix}")


def load_tokenizers(ckpt: dict):
    """Deserialize both BPE tokenizers from checkpoint vocab metadata."""
    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.load(io.BytesIO(ckpt["vocab"]["texttok.model"].encode("utf-8")))
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN)
    speechtok.load(io.BytesIO(ckpt["vocab"]["speechtok.model"].encode("utf-8")))
    return texttok, speechtok
