"""Data-parallel serving over the ``dp`` dim of a mesh
(counterpart of ``mars5_tts_tpu/serving/multichip.py``).

Each rank holds the whole model, takes its share of the batch rows, runs
the single-device engine on them and the ranks gather the results. Rows
never read each other and each row draws from its own slice of the batch's
randomness, so a sharded run is bit-identical to the single-process engine
over the whole batch, as the JAX package's DP is.

* ``ShardedARDecoder``: the batch is padded to a multiple of dp with rows
  that are done after their first (discarded) sample; each rank runs the
  batched bf16 engine (``models/ar_decode``) on its rows.
* ``ShardedNARDiffusion``: ``perform_simple_inference`` on each rank's rows
  of the whole batch (``batch_rows``): the layout of a ragged deep-clone
  batch, the injected uniforms and ``x_init`` are the whole batch's, and a
  generator draws at the whole batch's shape, each cut to the rank's rows.

Tensor-parallel decoding (``tp > 1``) is not ported yet (ROADMAP A5b);
tensor parallelism runs in training (``train.shard_train_state``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..diffusion.engine import perform_simple_inference
from ..models.ar_decode import (ArSampling, RowSampling, ROW_FIELDS, decode_step,
                                prefill_state, rows_from_sampling, sample_rows)
from ..parallel.mesh import make_mesh


def _dp_of(mesh, tp: int):
    mesh = mesh if mesh is not None else make_mesh(tp=tp)
    if mesh["tp"].size() > 1:
        raise NotImplementedError("tensor-parallel decoding (tp > 1) is not ported yet "
                                  "(ROADMAP A5b); shard the decoders on dp only")
    return mesh, mesh["dp"].size(), mesh.get_local_rank("dp")


class ShardedARDecoder:
    """Data-parallel batched AR generation: the whole model on every rank,
    the batch rows split across ``dp``; the tokens are those of
    ``ar_generate_batched`` over the whole batch, bit for bit."""

    def __init__(self, model: nn.Module, sampling: ArSampling, *, mesh=None, tp: int = 1):
        self.mesh, self.dp, self.rank = _dp_of(mesh, tp)
        self.model = model
        self.s = sampling

    def generate(self, prompts: Sequence[np.ndarray], spk_codes_list: Sequence[np.ndarray], *,
                 uniforms: Optional[Sequence[np.ndarray]] = None,
                 seeds: Optional[Sequence[int]] = None,
                 est_lens: Optional[Sequence[int]] = None,
                 rows: RowSampling | None = None):
        """Generate every request; returns [(tokens, n_gen)] per request, on
        every rank. Request i draws ``uniforms[i]`` (max_len,), else
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
        out = sample_rows(state, s, local_rows,
                          lambda t, pos: decode_step(self.model, t, pos, state.cache))
        gathered = [None] * self.dp
        dist.all_gather_object(gathered, out, group=self.mesh.get_group("dp"))
        return [r for part in gathered for r in part][:n_req]


class ShardedNARDiffusion:
    """Data-parallel NAR diffusion: batch rows split across ``dp``; the grid
    is ``perform_simple_inference``'s over the whole batch, bit for bit."""

    def __init__(self, model: nn.Module, *, mesh=None, tp: int = 1):
        self.mesh, self.dp, self.rank = _dp_of(mesh, tp)
        self.model = model

    def infer(self, batch, diff, T: int, dsh, *, generator: torch.Generator | None = None,
              uniforms=None, x_init=None, **kwargs):
        """Sharded ``perform_simple_inference`` (rows a multiple of dp): each
        rank runs its rows of the whole batch (``batch_rows``). Returns the
        (bs, Lx, 8) grid on the model's device, on every rank."""
        bs = int(np.shape(batch[0])[0])
        if bs % self.dp:
            raise ValueError(f"{bs} rows do not divide by dp={self.dp}")
        per = bs // self.dp
        grid = perform_simple_inference(self.model, batch, diff, T, dsh, generator=generator,
                                        uniforms=uniforms, x_init=x_init,
                                        batch_rows=(self.rank * per, (self.rank + 1) * per),
                                        **kwargs)
        parts = [torch.empty_like(grid) for _ in range(self.dp)]
        dist.all_gather(parts, grid.contiguous(), group=self.mesh.get_group("dp"))
        return torch.cat(parts)
