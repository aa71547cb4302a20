"""NAR waves: finished AR requests diffused together
(counterpart of ``mars5_tts_tpu/serving/nar_waves.py``).

A 200-step trajectory costs about the same a step for one row as for a few
on the frame-padded grid until the card is busy, so requests whose AR is
done are grouped into batched ``perform_simple_inference`` calls, waves,
instead of diffusing one by one. A wave's rows share:

* the reference-code length Lc (deep clone puts the prompt ahead of every
  row at one offset);
* the text bucket (text padded to it; each row's length masks the rest);
* the generated-length bucket (frames padded to it, masked by
  ``x_padding_mask`` and cropped after).

Rows do not read each other: under one injected stream, a wave row's grid
is the grid of the same request diffused alone. A wave draws from a
generator seeded with its first request's seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DSH
from ..diffusion.engine import perform_simple_inference
from ..diffusion.multinomial import MultinomialDiffusion
from ..models.layers import DEFAULT_OPTIONS, NarOptions
from ..models.nar import ResidualTransformer


@dataclass
class NarRequest:
    c_text: np.ndarray                  # (Lt,) BPE text ids
    c_codes: np.ndarray                 # (Lc, 8) reference codec codes
    l0_codes: np.ndarray                # (Lg,) the AR's L0 codes
    seed: int = 0
    grid: Optional[np.ndarray] = None   # (Lg, 8) once its wave has run


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


@dataclass
class NarWaveScheduler:
    """Batches compatible NAR requests into waves of at most ``wave_size``
    rows on ``nar`` (the NAR module; ``tail``, ``mega`` and ``options`` its
    routes, as ``perform_simple_inference`` takes them)."""

    nar: ResidualTransformer
    diff: MultinomialDiffusion
    T: int
    dsh: DSH
    wave_size: int = 4
    gen_buckets: Sequence[int] = (256, 512, 768)
    text_bucket: int = 64
    queue: list = field(default_factory=list)
    completed: list = field(default_factory=list)
    waves_run: int = 0
    tail: str = "heads"
    mega: object = None
    options: NarOptions = DEFAULT_OPTIONS

    def submit(self, request: NarRequest) -> NarRequest:
        _bucket(len(request.l0_codes), self.gen_buckets)      # refused early
        if len(request.c_text) > self.text_bucket:
            raise ValueError(f"text length {len(request.c_text)} exceeds bucket "
                             f"{self.text_bucket}")
        self.queue.append(request)
        return request

    def _wave_key(self, req: NarRequest):
        return req.c_codes.shape[0], _bucket(len(req.l0_codes), self.gen_buckets)

    def _run_wave(self, reqs: list) -> None:
        bs = len(reqs)
        lc, lg_bucket = self._wave_key(reqs[0])
        c_text = np.zeros((bs, self.text_bucket), np.int64)
        x = np.zeros((bs, lg_bucket, 8), np.int64)
        xpm = np.ones((bs, lg_bucket), bool)
        for j, r in enumerate(reqs):
            c_text[j, : len(r.c_text)] = r.c_text
            lg = len(r.l0_codes)
            x[j, :lg] = np.asarray(r.l0_codes)[:, None]
            xpm[j, :lg] = False
        batch = (c_text, np.stack([r.c_codes for r in reqs]).astype(np.int64),
                 np.asarray([len(r.c_text) for r in reqs]), np.full(bs, lc), x, xpm)
        dev = self.nar.text_embed.weight.device
        gen = torch.Generator(device=dev).manual_seed(reqs[0].seed)
        grid = perform_simple_inference(self.nar, batch, self.diff, self.T, self.dsh,
                                        generator=gen, tail=self.tail, mega=self.mega,
                                        options=self.options).cpu().numpy()
        self.waves_run += 1
        for j, r in enumerate(reqs):
            r.grid = grid[j, : len(r.l0_codes)]
            self.completed.append(r)

    def _groups(self) -> list:
        groups: dict[tuple, list] = {}
        for r in self.queue:
            groups.setdefault(self._wave_key(r), []).append(r)
        return sorted(groups.items())

    def flush(self) -> list:
        """Group the queue into compatible waves and run them all; returns
        every completed request."""
        groups = self._groups()
        self.queue = []
        for _key, reqs in groups:
            for i in range(0, len(reqs), self.wave_size):
                self._run_wave(reqs[i: i + self.wave_size])
        return self.completed

    def flush_full_waves(self) -> int:
        """Run only full waves (``wave_size`` compatible requests), keeping
        the rest queued in order, so that a serving loop can start diffusing
        a cohort between AR quanta; returns the waves run."""
        ran = 0
        remainder: list = []
        for _key, reqs in self._groups():
            n_full = len(reqs) // self.wave_size * self.wave_size
            for i in range(0, n_full, self.wave_size):
                self._run_wave(reqs[i: i + self.wave_size])
                ran += 1
            remainder.extend(reqs[n_full:])
        self.queue = remainder
        return ran
