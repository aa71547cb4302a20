"""Continuous batching of the AR: requests join and leave the rows of a
pool mid-flight (counterpart of ``mars5_tts_tpu/serving/continuous.py``).

A pool of ``batch_size`` rows decodes in quanta of ``chunk_steps`` steps;
between quanta, finished rows are harvested and waiting requests are
prefilled and inserted into free rows. Rows do not read each other, so a
request's tokens are those of its solo ``ar_generate`` run on the same
uniform stream.

Prompts are assigned to the smallest of ``prompt_buckets`` that fits (e.g.
(64, 576): shallow-clone prompts of about 30 tokens and deep-clone ones of
about 510), and each admission quantum runs one prefill call per bucket
(``prefills_by_bucket`` counts them). Unlike the JAX pool, whose static
shapes pad each bucket's prompts to the bucket, the port prefills each row
at its own length (``models/ar_decode.prefill_rows``), so a row's prompt
K/V are those of its solo run; the buckets only group the admissions. A
request may override its sampling values (``Request.sampling``), top_k up
to the pool's extraction width ``max_top_k``. Without ``Request.uniforms``
a request draws from ``torch.Generator(device).manual_seed(seed)``.

The pool runs on the engine it is given (``models/ar_decode``): the model
as loaded by default, or the quantized engine
(``models/ar_decode_fused.FusedEngine``, kernel K2 one call a decode step
for all rows, W8A8 or W4A8 weights, 2 to 8 rows).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.ar import CodecLM
from ..models.ar_decode import (MODEL_ENGINE, ROW_FIELDS, ArSampling, RowSampling,
                                decode_chunk, extract_row, insert_row, insert_rows_sampling,
                                make_parked_state, prefill_state, rows_from_sampling)


@dataclass
class Request:
    prompt: np.ndarray                    # 1-D token ids
    spk_codes: np.ndarray                 # (S, 8) reference codec codes
    seed: int = 0
    uniforms: Optional[np.ndarray] = None  # (max_len,) stream in place of the seed's
    # per-request sampling values (temperature, top_k, top_p, typical_p,
    # alpha_frequency, alpha_presence, penalty_window, eos_penalty_decay,
    # eos_penalty_factor); top_k up to the pool's max_top_k
    sampling: Optional[dict] = None
    # filled on completion:
    tokens: Optional[np.ndarray] = None
    n_gen: Optional[int] = None
    _row: int = -1


class ContinuousBatcher:
    """A fixed pool of rows over the AR ``engine`` (default ``MODEL_ENGINE``,
    ``model`` as loaded). On the quantized engine every decode step is one
    K2 call for the whole pool, parked rows included.

    The pool shares one ``ArSampling`` (vocab window, EOS id, ``max_len``;
    its top-k extraction width is ``max_top_k``), while each request's row
    carries its own sampling values."""

    def __init__(self, model: CodecLM, sampling: ArSampling, *, engine=None,
                 batch_size: int = 4, chunk_steps: int = 64,
                 prompt_buckets: Sequence[int] = (64,), spk_bucket: int = 64,
                 max_top_k: int | None = None):
        self.engine = engine or MODEL_ENGINE
        window = self.engine.fit(model.cfg, sampling, batch_size, pool=True)
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.model, self.cfg = model, model.cfg
        self.device = model.embed.weight.device
        if self.prompt_buckets[-1] + 1 > window:
            raise ValueError(f"prompt bucket {self.prompt_buckets[-1]}+1 exceeds window "
                             f"{window}")
        self.max_top_k = max_top_k if max_top_k is not None else sampling.top_k
        self.default_s = sampling
        self.s = dataclasses.replace(sampling, top_k=self.max_top_k)
        self.batch_size = batch_size
        self.chunk_steps = chunk_steps
        self.spk_bucket = spk_bucket
        self.state = make_parked_state(self.cfg, self.s, batch_size, model.embed.weight.dtype,
                                       self.device, self.engine)
        self.rows = rows_from_sampling(sampling, batch_size, cap_top_k=self.max_top_k)
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self.completed: list[Request] = []
        self.chunks_run = 0
        self.prefills_by_bucket: dict[int, int] = {b: 0 for b in self.prompt_buckets}

    # -------------------------------------------------------------- lifecycle
    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds bucket {self.prompt_buckets[-1]}")

    def submit(self, request: Request) -> Request:
        self._bucket_for(len(request.prompt))           # refused early
        if request.spk_codes.shape[0] > self.spk_bucket:
            raise ValueError(f"speaker codes of {request.spk_codes.shape[0]} frames exceed "
                             f"spk_bucket {self.spk_bucket}")
        if request.sampling and request.sampling.get("top_k", 0) > self.max_top_k:
            raise ValueError(f"request top_k {request.sampling['top_k']} exceeds pool "
                             f"max_top_k {self.max_top_k}")
        self.queue.append(request)
        return request

    def _uniforms(self, req: Request) -> torch.Tensor:
        if req.uniforms is not None:
            return torch.as_tensor(np.asarray(req.uniforms, np.float32), device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        return torch.rand((self.s.max_len,), generator=gen, device=self.device)

    def _admit(self) -> None:
        free = [b for b in range(self.batch_size)
                if b not in self.active and self.state.done[b]]
        take = min(len(free), len(self.queue))
        if take == 0:
            return
        by_bucket: dict[int, list] = {}
        for slot in free[:take]:
            req = self.queue.pop(0)
            by_bucket.setdefault(self._bucket_for(len(req.prompt)), []).append((slot, req))
        # one prefill call a bucket this quantum, each row at its own length
        for bucket, group in sorted(by_bucket.items()):
            row_list = [rows_from_sampling(self.default_s, 1, req.sampling,
                                           cap_top_k=self.max_top_k) for _, req in group]
            rows = RowSampling(**{n: np.concatenate([getattr(r, n) for r in row_list])
                                  for n in ROW_FIELDS})
            u = torch.stack([self._uniforms(req) for _, req in group], dim=1)
            batch = prefill_state(self.model, self.s, [np.asarray(req.prompt) for _, req in group],
                                  [np.asarray(req.spk_codes) for _, req in group], u, rows=rows,
                                  engine=self.engine)
            self.prefills_by_bucket[bucket] += 1
            for j, (slot, req) in enumerate(group):
                insert_row(self.state, extract_row(batch, j), slot)
                self.rows = insert_rows_sampling(self.rows, row_list[j], slot)
                req._row = slot
                self.active[slot] = req

    def _harvest(self) -> None:
        st = self.state
        for b, req in list(self.active.items()):
            if st.done[b]:
                req.tokens = st.tokens[b, : st.cur[b]].copy()
                req.n_gen = int(st.n_gen[b])
                self.completed.append(req)
                del self.active[b]

    def step(self) -> bool:
        """One scheduling quantum: admit, decode, harvest. Returns False when
        the pool and the queue are empty."""
        self._admit()
        if not self.active:
            return bool(self.queue)
        decode_chunk(self.model, self.s, self.state, self.chunk_steps, self.rows, self.engine)
        self.chunks_run += 1
        self._harvest()
        return bool(self.active or self.queue)

    def run(self, max_quanta: int = 10_000) -> list[Request]:
        """Drain the queue (at most ``max_quanta`` quanta); returns every
        completed request."""
        for _ in range(max_quanta):
            if not self.step():
                break
        return self.completed

    @property
    def steps_run(self) -> int:
        """Decode steps the pool has run (each one step of every row)."""
        return self.state.steps

