"""CUDA graphs of the AR decode step, made once a decode state for each
geometry and replayed at its later steps.

A decode step of the quantized engine is K2 (``fused_decode_layers``, one
cooperative launch) and then, around it, some sixty short launches: the
final norm and the head, the K/V rows quantized into the ring, the logit
pipeline, the draw and the state's bookkeeping. The host takes longer to
issue them than the card takes to run them, so the card waits on the host
for most of each step. ``StepGraphs`` records everything after the
step's direct calls as one CUDA graph over the decode state kept on the
device (``models/ar_decode.DeviceState``): each step then issues its direct
calls (K2, which reads the host's positions), replays the graph once and
queues the copy of its drawn tokens, which the host reads back once the
next step is queued (``decode_loop``). The latent-attention step has no
direct call: its forward and the draw are one replay.

At a geometry's first step (the key: the route, the filter blocks the rows
need and the sampling settings; the rows are the state's) the holder runs
the step's graphed part eagerly on a side stream, which gives that step's
tokens and is the warm-up capture needs, then captures it. Every later step
replays it: the same kernels on the same inputs, so the tokens are the
eager step's bit for bit. Everything the graph reads and writes keeps its
storage for the state's life: the device state, the penalty counts, the
uniforms, the cache and the route's static buffers; a pool's inserts write
them in place, so its graphs survive them.

The holder lives on the decode state and is dropped with it, its graphs
before their memory pool (``utils/cuda_graphs``). A step is graphed only
where capture is possible and gives the eager result: CUDA tensors,
autograd not recording and a route that can be captured (the quantized
engine's ``FusedCache``, or a ``LatentCache``); every other route (the
bf16 ring and K7, tensor-parallel ranks, the CPU) runs the same
device-side sampler eagerly. Patching ``takes`` to return False keeps
every route eager (the tests, ``chip_smoke.py``'s phase 8).

``graph_captures`` and ``graph_replays`` count the graphed steps: the first
of each geometry, and the others. The kernels' launch counters a graph
holds (K8's, K10's) count the kernels run: a capture leaves them as they
were, a replay adds its own.
"""

from __future__ import annotations

import torch

from ..ops.kernels import head4, moe_decode
from ..utils import cuda_graphs
from ..utils.profiling import span

# graphed decode steps in this process (reset with reset_counts)
graph_captures = 0
graph_replays = 0

# the kernels' launch counters a graph may move
_COUNTERS = ((head4, "launch_count"), (moe_decode, "launch_count"))


def reset_counts() -> None:
    global graph_captures, graph_replays
    graph_captures = graph_replays = 0


def _counts() -> list:
    return [getattr(m, n) for m, n in _COUNTERS]


def _set_counts(values) -> None:
    for (m, n), v in zip(_COUNTERS, values):
        setattr(m, n, v)


def takes(state, route) -> bool:
    """Whether ``route``'s steps on ``state`` are graphed: CUDA tensors,
    autograd not recording, a route that can be captured."""
    return state.counts.is_cuda and not torch.is_grad_enabled() and route.graphable


class StepGraphs:
    """The graphs of one decode state (module docstring)."""

    def __init__(self, device):
        self.device = device
        self._graphs = {}
        self._pool = None       # set after the graphs: dropped after them

    def run(self, key, fn) -> None:
        """One step's graphed part ``fn()``, which writes its results into
        storage that outlives the graph: eager and then captured at the
        first step of ``key``, replayed after."""
        global graph_captures, graph_replays
        made = self._graphs.get(key)
        if made is None:
            with cuda_graphs.on_side_stream(self.device):
                fn()
                if self._pool is None:
                    self._pool = cuda_graphs.new_pool()
                with span("ar.graph_capture"):
                    before = _counts()
                    graph, _ = cuda_graphs.capture(fn, self._pool)
                    launches = [b - a for a, b in zip(before, _counts())]
                    _set_counts(before)
            self._graphs[key] = (graph, launches)
            graph_captures += 1
            return
        graph, launches = made
        graph.replay()
        _set_counts(c + d for c, d in zip(_counts(), launches))
        graph_replays += 1
