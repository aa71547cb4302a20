"""Per-stage wall-clock timing and real-time factor, and the program's spans
on the ``torch.profiler`` clock.

``span(name)`` marks a range ``mars5.<name>`` in a running profiler's trace:
a request (``mars5.request``), each stage of ``StageTimer``
(``mars5.stage.<stage>``), the AR's prefill and decode steps
(``mars5.ar.*``) and the NAR's encoder memory and reverse steps
(``mars5.nar.*``). A span nests in the span around it on the calling thread,
so a step's spans sit in their stage and request with no id passed down.
With no profiler running it is one check and returns a shared null context:
nothing is recorded and no clock is read.

The ranges are recorded as the profiler's host ops (``RecordFunctionFast``,
not ``record_function``): a ``record_function`` range is a user annotation,
which the CUDA profiler copies onto the device's timeline as an event of its
own, and such copies would count as device activity in a reading of the
device's busy time.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
host_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


def span(name: str):
    """The profiler range ``mars5.<name>`` while a profiler records, else a
    shared null context."""
    if _profiler_enabled():
        return host_range("mars5." + name)
    return _NULL


@dataclass
class StageTimer:
    """Wall seconds per named stage. ``sync`` (e.g. ``torch.cuda.synchronize``)
    runs before each stage's clock stops, so asynchronous device work is
    charged to the stage that queued it. Each stage is also the span
    ``mars5.stage.<name>`` around its body and closing ``sync``."""

    stages: dict = field(default_factory=dict)
    sync: Optional[Callable[[], None]] = None

    @contextlib.contextmanager
    def stage(self, name: str):
        with span("stage." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync is not None:
                    self.sync()
                self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def rtf(self, audio_seconds: float) -> float:
        """Wall seconds per produced audio second (lower is faster)."""
        return self.total / max(audio_seconds, 1e-9)

    def report(self, audio_seconds: float | None = None) -> dict:
        out = {"stages_s": dict(self.stages), "total_s": self.total}
        if audio_seconds is not None:
            out["audio_s"] = audio_seconds
            out["rtf"] = self.rtf(audio_seconds)
        return out
