"""Tensor-parallel placements of the AR and NAR parameters
(counterpart of ``mars5_tts_tpu/parallel/sharding.py``).

Megatron-style layout over the ``tp`` mesh dim, in the port's (out, in)
Linear layout:

* column parallel (shard the output rows) -> ``Shard(0)``: the AR's
  wq / wk / wv and w1 / w3, the SwiGLU ``activation.W`` / ``.V`` of every
  NAR stack;
* row parallel (shard the input columns; the partial sums are reduced)
  -> ``Shard(1)``: the AR's wo and w2, every NAR ``out_proj`` and
  ``linear2``;
* the vocabulary of the AR's ``embed`` and ``ar.output`` -> ``Shard(0)``;
* the NAR's fused in-projections (3D, D) and their biases (3D,): each third
  (q, k, v) sharded on its own rows, ``_StridedShard(0, split_factor=3)``,
  so a rank holds the same heads of q, k and v (the JAX package stores them
  (3, D, D) and shards the per-third axis; ``in_proj_weight.view(3, D, D)``
  is then ``Shard(1)``); head-aligned whenever tp divides the heads;
* everything else (norms, the speaker encoder of the AR, embeddings of
  codes, timestep MLPs, heads) replicated.

The JAX package shards its fused (2F, D) SwiGLU kernel on the 2F axis, so
one rank may hold W and another V; the port shards W and V each, so every
rank holds matching halves. Every rule falls back to replication when the
dim does not divide by the tp size (``_maybe``), so any model runs on any
mesh.
"""

from __future__ import annotations

from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

COLUMN, ROW = Shard(0), Shard(1)
THIRDS = _StridedShard(0, split_factor=3)     # each of q, k, v on its own rows
VOCAB_PARAMS = ("embed.weight", "ar.output.weight")     # the AR's vocabulary-parallel tables


def _maybe(placement, shape, tp_size: int):
    """Replicate instead of shard when the sharded dim does not divide."""
    if isinstance(placement, _StridedShard):
        parts = tp_size * placement.split_factor
    elif isinstance(placement, Shard):
        parts = tp_size
    else:
        return placement
    return Replicate() if shape[placement.dim] % parts else placement


def _specs(module: nn.Module, rule, tp_size: int) -> dict:
    """On one tp device every parameter is whole: ``Replicate()``."""
    out = {}
    for name, p in module.named_parameters():
        placement = rule(name) if tp_size > 1 else None
        out[name] = Replicate() if placement is None else _maybe(placement, p.shape, tp_size)
    return out


def _ar_rule(name: str):
    if name in VOCAB_PARAMS:
        return COLUMN
    if not name.startswith("ar.layers."):
        return None
    leaf = name.split(".")[-2]
    if leaf in ("wq", "wk", "wv", "w1", "w3"):
        return COLUMN
    if leaf in ("wo", "w2"):
        return ROW
    return None


def _nar_rule(name: str):
    if not name.startswith(("tfm.encoder.layers.", "tfm.decoder.layers.",
                            "spk_encoder.layers.")):
        return None
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return THIRDS
    if name.endswith(("activation.W.weight", "activation.V.weight")):
        return COLUMN
    if name.endswith(("out_proj.weight", "linear2.weight")):
        return ROW
    return None


def codeclm_specs(model: nn.Module, tp_size: int) -> dict:
    """{parameter name: tp placement} of a ``CodecLM``; tp > 1 shards the
    MARS5 block's heads and FFN, and refuses a block with latent attention
    or experts."""
    if tp_size > 1 and not model.cfg.is_mha:
        raise ValueError("tensor parallelism shards the MARS5 block (multi-head attention, a "
                         "dense SwiGLU); an AR with latent attention or experts runs at tp 1")
    return _specs(model, _ar_rule, tp_size)


def nar_specs(model: nn.Module, tp_size: int) -> dict:
    """{parameter name: tp placement} of a ``ResidualTransformer``."""
    return _specs(model, _nar_rule, tp_size)
