"""CUDA graphs of the fused W8A8 NAR decoder stack, made once a trajectory
for each geometry and replayed at its later reverse steps.

A reverse step of the per-layer W8A8 decoder launches about 80 kernels a
layer, most of them short (the unfused products, the plain
cross-attention, casts and residual adds): the host takes longer to
launch them than the card takes to run them. ``DecoderGraphs`` records
the stack's chain (``TransformerDecoder.w8a8_chain``) between two FFN
calls as one CUDA graph, a segment: the first segment holds the decoder's
input stream (``ResidualTransformer.decoder_stream``) and the first
layer up to its FFN, each later one the next layer up to its FFN, and the
last one the final LayerNorm. The FFN, kernel K4
(``layers.fused_ffn``), stays a direct call between two replays, writing
into the next segment's static input, so that each K4 call is still a
Python call that launches its kernels itself. Where ``options.sites``
lacks ``"ffn"`` there is no K4 call, and the whole stack is one segment.

A trajectory (``diffusion/engine._trajectory``) makes one holder and
drops it at its end, with its graphs and their memory pool, a
``torch.cuda.MemPool``: dropped after the graphs, it gives its memory
back to the card. (A pool from ``torch.cuda.graph_pool_handle`` would stay
reserved until ``torch.cuda.empty_cache`` or an allocation that fails,
0.12-0.28 GB more after each trajectory at the released widths on an
H100; PyTorch 2.11 refuses to capture again into a pool whose graphs are
gone, so a pool is not kept for the next trajectory either.) At the
first step of a geometry (the shapes of x and the memory, and
``q_tail_start``) the holder runs the chain eagerly on a side stream,
which gives that step's output and is the warm-up capture needs, then
captures each segment; each later step copies its x, t_dec and memory
into the static inputs and replays. The padding masks are read in place:
they must keep their storage for the trajectory.

The holder takes a call only where capture is possible and gives the
eager result bit for bit (the same kernels on the same inputs): CUDA
tensors, autograd not recording, a quantized stack on the fused route, no
K9 pack (``mega``) and no tensor-parallel rank (whose collectives are not
captured). Anything else runs eagerly, as before.

``graph_captures`` and ``graph_replays`` count the graphed decoder calls:
the first of each geometry, and the others. The kernels' own launch
counters (``mha.launch_count``, ``nar_fused.fused_linear_launches``, ...)
count the kernels run either way: a capture, which runs nothing, leaves
them as they were, and a replay adds what its segments launch.
"""

from __future__ import annotations

import functools

import torch

from ..ops.kernels import mha, nar_fused
from ..utils import cuda_graphs
from ..utils.profiling import span

# graphed decoder calls in this process (reset with reset_counts)
graph_captures = 0
graph_replays = 0

# the kernels' launch counters a segment may move
_COUNTERS = ((mha, "launch_count"), (mha, "int8_launch_count"),
             (nar_fused, "fused_linear_launches"), (nar_fused, "fused_linear_grouped_launches"),
             (nar_fused, "fused_ffn_launches"), (nar_fused, "fused_ffn_grouped_launches"))


def reset_counts() -> None:
    global graph_captures, graph_replays
    graph_captures = graph_replays = 0


def _counts() -> list:
    return [getattr(m, n) for m, n in _COUNTERS]


def _set_counts(values) -> None:
    for (m, n), v in zip(_COUNTERS, values):
        setattr(m, n, v)


def _run(fns, h):
    for fn in fns:
        h = fn(h)
    return h


def _same_storage(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return (a.data_ptr(), a.shape, a.stride()) == (b.data_ptr(), b.shape, b.stride())


class _Geometry:
    """The graphs of one geometry: the static inputs (x and t_dec, the
    memory), the masks as captured, and for each segment its graph, its
    static output, the K4 call after it (None after the last), its static
    input (None for the first) and the kernel launches a replay makes."""

    def __init__(self, inputs, memory, masks):
        self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                            for t in inputs)
        self.memory = torch.empty(memory.shape, dtype=memory.dtype, device=memory.device)
        self.masks = masks
        self.graphs, self.outs, self.ffns, self.ins, self.launches = [], [], [], [], []

    def feed(self, inputs, memory, masks):
        if not all(_same_storage(a, b) for a, b in zip(self.masks, masks)):
            raise ValueError("DecoderGraphs: the padding masks must keep their storage "
                             "for the whole trajectory")
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.memory.copy_(memory)


class DecoderGraphs:
    """The decoder's graphs for one trajectory (module docstring)."""

    def __init__(self):
        self._geometries = {}
        self._pool = None       # set after the graphs: dropped after them

    @staticmethod
    def graphable(decoder, mega, options) -> bool:
        """Whether a call of ``decoder`` (a ``TransformerDecoder``) can be
        graphed, its device aside: autograd not recording, the quantized
        stack on the fused route, no K9 pack, no tensor-parallel rank."""
        last = decoder.layers[-1]
        return (mega is None and options.fused and last.is_quantized
                and last.self_attn.tp is None and not torch.is_grad_enabled())

    def takes(self, decoder, x, mega, options) -> bool:
        """``graphable`` on CUDA tensors."""
        return x.is_cuda and self.graphable(decoder, mega, options)

    def run(self, model, x, t_dec, memory, x_padding_mask, c_padding, q_tail_start, options):
        """``model.decoder_apply``'s output for one step (a call ``takes``
        took): that of the eager stack, bit for bit. A replay's output is
        its last segment's static output, valid until the next call."""
        global graph_captures, graph_replays
        inputs, masks = (x, t_dec), (x_padding_mask, c_padding)
        key = (tuple(x.shape), tuple(memory.shape), q_tail_start)
        geo = self._geometries.get(key)
        if geo is None:
            geo = self._geometries[key] = _Geometry(inputs, memory, masks)
            geo.feed(inputs, memory, masks)
            chain = model.tfm.decoder.w8a8_chain(geo.memory, x_padding_mask, c_padding,
                                                 q_tail_start, options)
            out = self._record(geo, [(lambda _: model.decoder_stream(*geo.inputs), False),
                                     *chain])
            graph_captures += 1
            return out
        geo.feed(inputs, memory, masks)
        for graph, out, ffn, nxt, launches in zip(geo.graphs, geo.outs, geo.ffns,
                                                  geo.ins[1:] + [None], geo.launches):
            graph.replay()
            _set_counts(c + d for c, d in zip(_counts(), launches))
            if ffn is not None:
                ffn(out, out=nxt)
        graph_replays += 1
        return geo.outs[-1]

    def _record(self, geo, chain):
        """Splits ``chain`` into segments at its K4 calls, runs it eagerly
        (this step's output), then captures each segment on its eager
        input."""
        segments, fns = [], []
        for fn, is_ffn in chain:
            if is_ffn:
                segments.append((fns, fn))
                fns = []
            else:
                fns.append(fn)
        segments.append((fns, None))
        with cuda_graphs.on_side_stream(geo.memory.device):
            if self._pool is None:
                self._pool = cuda_graphs.new_pool()
            h = None
            for fns, ffn in segments:
                geo.ins.append(h)
                h = _run(fns, h)
                if ffn is not None:
                    h = ffn(h)
            with span("nar.graph_capture"):
                for (fns, ffn), h_in in zip(segments, geo.ins):
                    before = _counts()
                    graph, out = cuda_graphs.capture(functools.partial(_run, fns, h_in),
                                                    self._pool)
                    geo.launches.append([b - a for a, b in zip(before, _counts())])
                    _set_counts(before)
                    geo.graphs.append(graph)
                    geo.outs.append(out)
                    geo.ffns.append(ffn)
        return h
