"""Tensor-parallel decoding on plain local tensors
(the serving half of ``parallel/sharding.py``'s layout).

Training places the parameters as DTensors (``mesh.shard_tree``) and lets
DTensor dispatch insert the collectives. A decode step is host-bound eager
PyTorch (some 1,200 launches a token at the released AR widths), and
DTensor dispatch on every op would add to each of them; the kernels K7 and
K1 also take plain CUDA tensors. So a decoder runs on a copy of the model
that holds only this rank's shards as plain tensors (``shard_module``, from
the same placements as training: ``codeclm_specs`` / ``nar_specs``), and
the modules that own a collective carry a :class:`TensorParallel` as their
``tp``:

* ``Attention`` / ``FeedForward`` (AR) and ``MultiheadAttention`` /
  ``EncoderLayer`` (NAR): the row-parallel wo / w2 / out_proj / linear2
  products are partial sums, reduced (``reduce``); a row-parallel bias is
  added once, after the reduce;
* ``CodecLM``: its vocabulary-parallel ``embed`` (``lookup``);
* ``MistralTransformer``: its vocabulary-parallel output head, whose
  shards are gathered (``gather``) so that every rank holds the whole
  (B, V) logits and samples the same token from the same uniforms.

Every collective returns the same values on every rank of the group
(a sum reduced once and broadcast, or a gather), so the replicated work
around them (norms, sampling, the NAR's heads and tail) is identical
across the ranks. A module whose row-parallel weight ``_maybe`` left whole
(its dim does not divide by tp) has no ``tp`` and reduces nothing.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.placement_types import _StridedShard

from ..ops.embeddings import local_vocab_lookup
from .sharding import VOCAB_PARAMS


class TensorParallel:
    """One rank of a tp group: ``size`` ranks, this one ``rank``.

    The sums run in f32 whatever the activations' dtype: the ranks' partials
    (each in the activations' dtype) are summed in f32, and the sum rounds
    once, back to that dtype. Every collective is an all-reduce, which NCCL
    and gloo both take on CUDA tensors (two ranks sharing one card run over
    gloo: NCCL refuses two ranks on one device)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, mesh) -> "TensorParallel | None":
        """The ``tp`` dim of a (dp, tp) mesh (``parallel.make_mesh``), or
        None when it holds one rank."""
        if mesh["tp"].size() == 1:
            return None
        return cls(mesh.get_group("tp"), mesh.get_local_rank("tp"), mesh["tp"].size())

    def _sum(self, t):
        """``t`` (f32) summed over the group, on every rank."""
        dist.all_reduce(t, group=self.group)
        return t

    def reduce(self, partial, bias=None):
        """The whole product from this rank's ``partial`` sum of a
        row-parallel product, then ``bias`` (added once, in the product's
        dtype, as ``ops.attention.linear`` adds it)."""
        y = self._sum(partial.float()).to(partial.dtype)
        return y if bias is None else y + bias.to(y.dtype)

    def gather(self, local):
        """(..., n / size) column shards -> (..., n), rank r's at columns
        [r n / size, (r + 1) n / size): one f32 sum of zero-padded buffers
        (x + 0 is exact, and gloo's all-reduce takes what its all-gather
        does not: CUDA tensors)."""
        n = local.shape[-1]
        buf = local.new_zeros((*local.shape[:-1], n * self.size), dtype=torch.float32)
        buf[..., self.rank * n:(self.rank + 1) * n] = local
        return self._sum(buf).to(local.dtype)

    def lookup(self, local_table, ids):
        """``table[ids]`` of a vocabulary-sharded table from this rank's
        rows (``ops.embeddings.local_vocab_lookup``, Megatron's
        vocabulary-parallel embedding), summed over the group: exact, one
        rank holds each id."""
        start = self.rank * local_table.shape[0]
        return self.reduce(local_vocab_lookup(local_table, ids, start))


def local_shard(p: torch.Tensor, placement, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``p`` under a tp ``placement`` of
    ``parallel/sharding.py``: ``Shard(d)`` an even slice of dim d;
    ``_StridedShard(0, split_factor=3)`` the same rows of each third (the
    q, k and v of a fused in-projection: the rank's heads of each);
    ``Replicate()`` all of it."""
    if isinstance(placement, _StridedShard):
        parts = p.reshape(placement.split_factor, -1, *p.shape[1:])
        n = parts.shape[1] // size
        return parts[:, rank * n:(rank + 1) * n].reshape(-1, *p.shape[1:])
    if placement.is_shard():
        return p.tensor_split(size, dim=placement.dim)[rank]
    return p


@torch.no_grad()
def shard_module(module: nn.Module, specs: dict, tp: TensorParallel) -> nn.Module:
    """A copy of ``module`` that holds rank ``tp.rank``'s part of each
    parameter (``specs``: name -> tp placement, from ``codeclm_specs`` /
    ``nar_specs``) as a plain contiguous tensor of its own (a replicated
    one shares ``module``'s), and ``tp`` on each module that owns a sharded
    vocabulary or a row-parallel product. ``module`` is left as it is."""
    memo = {}
    sharded = set()
    for name, p in module.named_parameters():
        placement = specs.get(name, Replicate())
        local = p.detach()
        if not placement.is_replicate():
            local = local_shard(local, placement, tp.rank, tp.size).clone(
                memory_format=torch.contiguous_format)
            if placement.dim == 1 or name in VOCAB_PARAMS:
                # the module holding the Linear or Embedding runs the collective
                # (``ar.layers.0.attention.wo.weight`` -> ``ar.layers.0.attention``)
                sharded.add(name.rpartition(".")[0].rpartition(".")[0])
        memo[id(p)] = nn.Parameter(local, requires_grad=False)
    out = copy.deepcopy(module, memo)
    for owner in sharded:
        out.get_submodule(owner).tp = tp
    return out
