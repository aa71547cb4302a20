"""Sinusoidal position, diffusion timestep and chunked codebook embeddings
(counterpart of ``mars5_tts_tpu/ops/embeddings.py``)."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ..utils.device import is_dtensor


def sine_pe_table(length: int, dim: int, device=None):
    """(length, dim) f32 table: pe[:, 0::2] = sin, pe[:, 1::2] = cos."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                         * -(math.log(10000.0) / dim))
    ang = position * div_term
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(length, -1)
    return pe[:, :dim]


def add_sine_pe(x, alpha):
    """``x + alpha * pe[:L]`` for x (..., L, dim); alpha is the learnable (1,)."""
    pe = sine_pe_table(x.shape[-2], x.shape[-1], device=x.device)
    return (x.float() + alpha.float() * pe).to(x.dtype)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32):
    """(N,) timesteps -> (N, dim) ``[cos, sin]`` embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


def lookup(table, idx):
    """``table[idx]`` as ``F.embedding``, also for a DTensor table held whole
    on its mesh; a table sharded along its rows (vocabulary-parallel) takes
    ``_vocab_parallel_lookup``."""
    if is_dtensor(table) and any(p.is_shard(0) for p in table.placements):
        return _vocab_parallel_lookup(table, idx)
    return F.embedding(idx, table)


def _vocab_parallel_lookup(table, idx):
    """``table[idx]`` for a DTensor table sharded along its rows on one mesh
    dim (Megatron's vocabulary-parallel embedding): each device looks its
    ids up in its own rows, zeros for ids outside them, and the rows sum
    over that dim. Plain tensor work between ``to_local`` and
    ``from_local``, so no DTensor rule of the gather or of its backward is
    needed. ``idx`` is a DTensor on the same mesh or a plain tensor held
    whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    (dim,) = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    ids_placements = idx.placements if is_dtensor(idx) else (Replicate(),) * mesh.ndim
    if not ids_placements[dim].is_replicate():
        raise ValueError("the ids must be whole on the dim that splits the table")
    # where the ids are split (dp), each device's rows gather the gradient
    # of its own ids only: partial sums
    local = table.to_local(grad_placements=[
        Partial() if i != dim and p.is_shard() else table.placements[i]
        for i, p in enumerate(ids_placements)])
    rows = local.shape[0]
    if rows * mesh.size(dim) != table.shape[0]:
        raise ValueError(f"{table.shape[0]} rows do not split evenly over {mesh.size(dim)}")
    start = mesh.get_local_rank(dim) * rows
    out = local_vocab_lookup(local, idx.to_local() if is_dtensor(idx) else idx, start)
    placements = [Partial() if i == dim else p for i, p in enumerate(ids_placements)]
    out = DTensor.from_local(out, mesh, placements, run_check=False)
    return out.redistribute(mesh, [Replicate() if i == dim else p
                                   for i, p in enumerate(placements)])


def local_vocab_lookup(local, ids, start: int):
    """The rows of ``ids`` that fall in one shard of a vocabulary-sharded
    table, ``local`` holding rows [start, start + len(local)); zeros for the
    ids outside it. Summed over the shards, this is ``table[ids]``."""
    inside = (ids >= start) & (ids < start + local.shape[0])
    return F.embedding(torch.where(inside, ids - start, 0), local) * inside[..., None]


def chunked_embed(tables, x):
    """Per-codebook lookups of x (..., n_q) in ``tables[i]``, concatenated."""
    return torch.cat([lookup(t, x[..., i]) for i, t in enumerate(tables)], dim=-1)
