"""The capture policy the port's CUDA graphs share (``models/nar_graphs``'
decoder segments and ``models/ar_graphs``' decode steps): a side stream to
capture on, a memory pool a holder drops after its graphs, and the capture
itself."""

from __future__ import annotations

import contextlib

import torch

_side_streams: dict = {}


@contextlib.contextmanager
def on_side_stream(device):
    """Runs the block on this process's side stream of ``device``, ordered
    after the current stream's work and before its later work. One stream
    a device: cuBLAS keeps a workspace for each stream it runs on."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _side_streams:
        _side_streams[idx] = torch.cuda.Stream(idx)
    side, cur = _side_streams[idx], torch.cuda.current_stream(idx)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


def new_pool():
    """A new ``MemPool`` on the current device. A capture allocates only from
    its own pool and cannot draw on the default pool's cache: where the card
    has less memory free than that cache holds idle (reserved, not
    allocated), the cache is first given back, so that the capture has at
    least the room the eager calls had. A batched call's encoder memory over
    all T steps (tens of GB at 8 rows) stays cached, and would otherwise
    leave the capture out of memory."""
    idle = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    if torch.cuda.mem_get_info()[0] < idle:
        torch.cuda.empty_cache()
    return torch.cuda.MemPool()


def capture(fn, pool):
    """(the CUDA graph of ``fn()`` on the current stream, in ``pool``, and
    fn's output, which each replay rewrites)."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool.id, capture_error_mode="thread_local")
    try:
        out = fn()
    finally:
        graph.capture_end()
    return graph, out
