"""Checkpoint loading: the reference's dual .pt / .safetensors format.

* ``.safetensors``: model tensors as keys; both BPE tokenizer model files embedded
  as UTF-8 strings in the file *metadata* under ``texttok.model`` /
  ``speechtok.model`` (and an optional ``mars5_config`` JSON).
* ``.pt``: a dict with ``'vocab'`` and ``'model'`` keys (and, when the port
  wrote a non-default geometry, ``'config'``, which the JAX loader ignores).

Parameter pytrees (the Encodec and Vocos parameters, nested dicts and lists
of arrays) go to ``.npz`` with "/"-joined key paths, a list's items under
their indices: the JAX package's layout, so either package reads what the
other wrote. ``load_codec_params`` also converts an official Encodec or
Vocos torch checkpoint on the fly.

The port's own copy of ``mars5_tts_tpu/hub.py``; tensors come back as numpy
arrays.
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
        out = {"vocab": raw.get("vocab", {}),
               "model": {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
                         for k, v in model.items()}}
        if "model" in raw and "config" in raw:
            out["config"] = dict(raw["config"])
        return out
    raise ValueError(f"unsupported checkpoint format: {path.suffix}")


def save_checkpoint(path, model: dict, vocab: dict | None = None,
                    config: dict | None = None) -> None:
    """Write a checkpoint in the layout ``load_checkpoint`` reads, chosen by
    the suffix. ``.safetensors``: the tensors, the tokenizer model files in
    the metadata and ``config`` (optional) as JSON under ``mars5_config``, as
    the JAX package writes it. A torch suffix (``.pt``, ``.pth``, ``.bin``,
    ``.th``): the reference's ``{"vocab", "model"}`` dict of torch tensors
    through ``torch.save``, with ``config`` under ``"config"`` when given.
    Anything else raises ValueError."""
    path = Path(path)
    tensors = {k: np.ascontiguousarray(np.asarray(v)) for k, v in model.items()}
    if path.suffix == ".safetensors":
        from safetensors.numpy import save_file

        metadata = {k: str(v) for k, v in (vocab or {}).items()}
        if config is not None:
            metadata["mars5_config"] = json.dumps(config)
        save_file(tensors, str(path), metadata=metadata or None)
        return
    if path.suffix in (".pt", ".pth", ".bin", ".th"):
        import torch

        raw = {"vocab": dict(vocab or {}),
               "model": {k: torch.from_numpy(np.require(v, requirements="W"))
                         for k, v in tensors.items()}}
        if config is not None:
            raw["config"] = dict(config)
        torch.save(raw, str(path))
        return
    raise ValueError(f"unsupported checkpoint format: {path.suffix}")


def load_tokenizers(ckpt: dict):
    """Deserialize both BPE tokenizers from checkpoint vocab metadata."""
    texttok = RegexTokenizer(GPT4_SPLIT_PATTERN)
    texttok.load(io.BytesIO(ckpt["vocab"]["texttok.model"].encode("utf-8")))
    speechtok = CodebookTokenizer(GPT4_SPLIT_PATTERN)
    speechtok.load(io.BytesIO(ckpt["vocab"]["speechtok.model"].encode("utf-8")))
    return texttok, speechtok


def _flatten(node, prefix, out):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, prefix + [str(k)], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, prefix + [str(i)], out)
    elif node is not None:
        if hasattr(node, "detach"):
            node = node.detach().cpu().numpy()
        out["/".join(prefix)] = np.asarray(node)


def save_pytree_npz(path, tree) -> None:
    """Save a parameter tree of nested dicts and lists (or tuples) of arrays
    as ``.npz``, each leaf under its "/"-joined key path (a list item under
    its index); ``None`` holds no leaf."""
    flat: dict = {}
    _flatten(tree, [], flat)
    np.savez(str(path), **flat)


def load_pytree_npz(path):
    """Inverse of ``save_pytree_npz``: a dict for string keys, a list where
    every key of a level is a digit."""
    data = np.load(str(path))
    root: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [finalize(node[str(i)]) for i in range(len(node))]
        return {k: finalize(v) for k, v in node.items()}

    return finalize(root)


def load_codec_params(path, kind: str, cfg=None):
    """Encodec (``kind="encodec"``) or Vocos (``"vocos"``) parameters as the
    pytree ``encodec_from_pytree`` / ``vocos_from_pytree`` take: from ``.npz``
    (``save_pytree_npz``) or from a torch checkpoint with the official key
    names (a ``state_dict`` wrapper is unwrapped), converted at the released
    config unless ``cfg`` is given."""
    path = str(path)
    if path.endswith(".npz"):
        return load_pytree_npz(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if kind == "encodec":
        from .models.encodec import EncodecConfig, convert_encodec
        return convert_encodec(sd, cfg or EncodecConfig())
    if kind == "vocos":
        from .models.vocos import VocosConfig, convert_vocos
        return convert_vocos(sd, cfg or VocosConfig())
    raise ValueError(f"unknown codec kind: {kind}")
