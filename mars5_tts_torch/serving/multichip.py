"""Data- and tensor-parallel serving over a (dp, tp) mesh
(counterpart of ``mars5_tts_tpu/serving/multichip.py``).

Rows split over ``dp``: each dp rank takes its share of the batch rows,
runs the single-device engine on them and the ranks gather the results.
Rows never read each other and each row draws from its own slice of the
batch's randomness, so a dp-sharded run is bit-identical to the
single-process engine over the whole batch, as the JAX package's DP is.

Weights shard over ``tp`` (``tp > 1``), Megatron-style, by the placements
training uses (``parallel/sharding.codeclm_specs`` / ``nar_specs``, each
falling back to replication where a dim does not divide). The engines run
on a copy holding each rank's shards as plain tensors with explicit
collectives (``parallel/tp.py``): a reduce after each row-parallel
product, the AR's vocabulary-parallel embedding and its gathered logits.
On the card the AR's decode attention is kernel K7 over each rank's heads
and rings, and the NAR's self-attention from 512 frames up kernel K1 on
each rank's heads. Every tp rank ends with the same logits and draws the
same tokens and grid. A row-parallel product sums its partials in another
order than one process does, so the tokens equal the one-process run's
wherever no sampled logit is within that rounding of a tie: in f32 at the
test sizes they are equal; at the released widths in bf16, on seeded
random weights, they part within a few tokens, as one process's bf16 and
f32 runs do (``chip_smoke.py`` phase 6 (e) reports both).

* ``ShardedARDecoder``: the batch is padded to a multiple of dp with rows
  that are done after their first (discarded) sample; each rank runs the
  batched bf16 engine (``models/ar_decode``) on its rows, at tp > 1 on its
  heads. The quantized AR engines are not sharded (nor are JAX's).
* ``ShardedNARDiffusion``: ``perform_simple_inference`` on each rank's rows
  of the whole batch (``batch_rows``): the layout of a ragged deep-clone
  batch, the injected uniforms and ``x_init`` are the whole batch's, and a
  generator draws at the whole batch's shape, each cut to the rank's rows.
  The CFG doubling, the heads and the tail run replicated over tp. A W8A8
  NAR is refused at tp > 1 (JAX shards the float tree only).

One card cannot hold two NCCL ranks, so there the tp ranks run over gloo,
whose all-reduce copies CUDA tensors through the host (``chip_smoke.py``
phase 6 (e)): that checks the distributed code on the card, not TP's
speed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..diffusion.engine import perform_simple_inference
from ..models.ar_decode import (ArSampling, RowSampling, ROW_FIELDS, decode_chunk,
                                prefill_state, rows_from_sampling)
from ..parallel.mesh import make_mesh
from ..parallel.sharding import codeclm_specs, nar_specs
from ..parallel.tp import TensorParallel, shard_module


def _mesh_of(mesh, tp: int):
    """(mesh, dp size, dp rank, ``TensorParallel`` or None at tp 1)."""
    mesh = mesh if mesh is not None else make_mesh(tp=tp)
    return mesh, mesh["dp"].size(), mesh.get_local_rank("dp"), TensorParallel.of(mesh)


def _check_tp(model, heads: tuple, tp: TensorParallel | None) -> None:
    """tp > 1 takes a float model whose head counts divide by it."""
    if tp is None:
        return
    if model.is_quantized:
        raise ValueError("tensor-parallel decoding shards the float model; a quantized one "
                         "runs on dp alone")
    if any(h % tp.size for h in heads):
        raise ValueError(f"attention heads {heads} do not divide by tp={tp.size}")


class ShardedARDecoder:
    """Batched AR generation over a (dp, tp) mesh: the batch rows split
    across ``dp``, the bf16 model's heads, FFN and vocabulary across ``tp``
    (``model`` is left whole; each rank holds a copy of its shards). At tp
    1 the tokens are those of ``ar_generate_batched`` over the whole batch,
    bit for bit, and its steps run as that call's do (the model's own
    engine: on the card a latent-attention model's step is one CUDA graph
    replay)."""

    def __init__(self, model: nn.Module, sampling: ArSampling, *, mesh=None, tp: int = 1):
        self.mesh, self.dp, self.rank, self.tp = _mesh_of(mesh, tp)
        _check_tp(model, (model.cfg.n_heads, model.cfg.n_kv_heads), self.tp)
        if self.tp is not None:
            model = shard_module(model, codeclm_specs(model, self.tp.size), self.tp)
        self.model = model
        self.s = sampling

    def generate(self, prompts: Sequence[np.ndarray], spk_codes_list: Sequence[np.ndarray], *,
                 uniforms: Optional[Sequence[np.ndarray]] = None,
                 seeds: Optional[Sequence[int]] = None,
                 est_lens: Optional[Sequence[int]] = None,
                 rows: RowSampling | None = None):
        """Generate every request; returns [(tokens, n_gen)] per request, on
        every rank (dp and tp). Request i draws ``uniforms[i]`` (max_len,), else
        ``max_len`` uniforms of a CPU ``torch.Generator`` seeded ``seeds[i]``
        (default i); ``est_lens`` and ``rows`` as ``ar_generate_batched``'s."""
        s, dev = self.s, self.model.embed.weight.device
        n_req = len(prompts)
        bs = -(-n_req // self.dp) * self.dp
        u = np.zeros((s.max_len, bs), np.float32)
        for i in range(bs):
            if uniforms is not None and i < n_req:
                u[:, i] = np.asarray(uniforms[i], np.float32)[: s.max_len]
            else:
                seed = seeds[i] if seeds is not None and i < n_req else i
                u[:, i] = torch.rand(s.max_len, generator=torch.Generator().manual_seed(seed))
        est = np.full(bs, s.n_phones_gen, np.int64)
        if est_lens is not None:
            est[:n_req] = np.asarray(est_lens, np.int64)
        full = rows_from_sampling(s, bs)
        if rows is not None:
            for n in ROW_FIELDS:
                getattr(full, n)[:n_req] = getattr(rows, n)
        per = bs // self.dp
        lo, hi = self.rank * per, (self.rank + 1) * per
        mine = [i if i < n_req else 0 for i in range(lo, hi)]     # pad rows copy request 0
        local_rows = RowSampling(**{n: getattr(full, n)[lo:hi].copy() for n in ROW_FIELDS})
        state = prefill_state(self.model, s, [prompts[i] for i in mine],
                              [spk_codes_list[i] for i in mine],
                              torch.as_tensor(u[:, lo:hi].copy(), device=dev), est[lo:hi],
                              local_rows)
        state.done |= np.arange(lo, hi) >= n_req           # a pad row is done
        out = decode_chunk(self.model, s, state, None, local_rows).results()
        gathered = [None] * self.dp
        dist.all_gather_object(gathered, out, group=self.mesh.get_group("dp"))
        return [r for part in gathered for r in part][:n_req]


class ShardedNARDiffusion:
    """NAR diffusion over a (dp, tp) mesh: batch rows split across ``dp``,
    the float model's attention (head-aligned) and SwiGLU FFNs across
    ``tp``. At tp 1 the grid is ``perform_simple_inference``'s over the
    whole batch, bit for bit."""

    def __init__(self, model: nn.Module, *, mesh=None, tp: int = 1):
        self.mesh, self.dp, self.rank, self.tp = _mesh_of(mesh, tp)
        _check_tp(model, (model.cfg.nhead,), self.tp)
        if self.tp is not None:
            model = shard_module(model, nar_specs(model, self.tp.size), self.tp)
        self.model = model

    def infer(self, batch, diff, T: int, dsh, *, generator: torch.Generator | None = None,
              uniforms=None, x_init=None, **kwargs):
        """Sharded ``perform_simple_inference`` (rows a multiple of dp): each
        rank runs its rows of the whole batch (``batch_rows``). Returns the
        (bs, Lx, 8) grid on the model's device, on every rank (dp and tp)."""
        bs = int(np.shape(batch[0])[0])
        if bs % self.dp:
            raise ValueError(f"{bs} rows do not divide by dp={self.dp}")
        per = bs // self.dp
        grid = perform_simple_inference(self.model, batch, diff, T, dsh, generator=generator,
                                        uniforms=uniforms, x_init=x_init,
                                        batch_rows=(self.rank * per, (self.rank + 1) * per),
                                        **kwargs)
        if self.dp == 1:
            return grid
        parts = [torch.empty_like(grid) for _ in range(self.dp)]
        dist.all_gather(parts, grid.contiguous(), group=self.mesh.get_group("dp"))
        return torch.cat(parts)
