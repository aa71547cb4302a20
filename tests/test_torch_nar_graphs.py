"""The W8A8 NAR decoder's CUDA graphs (``models/nar_graphs.py``) on the CPU.

CUDA graphs need a card, so on the CPU the holder stays off: a trajectory
captures nothing and its grid is the eager one. The holder's own work (the
chain cut into segments at the K4 calls, the static inputs fed each step,
K4 writing into the next segment's input, one capture a geometry) is held
to the eager stack bit for bit with the capture swapped, in the test only,
for a stand-in that records the segment's function and reruns it into the
same output at each replay. The card's graphs are held to the eager stack
in ``tests/test_torch_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

K, STEPS = 1025, 8


def _nar(seed=0):
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.ops.quant import quantize_nar

    cfg = ResidualTransformerConfig.tiny()
    model = ResidualTransformer(cfg).init_(torch.Generator().manual_seed(seed))
    return quantize_nar(model.to(torch.bfloat16).eval())


def _batch(rng, rows=1, gen=24, prompts=(15,), text_len=9):
    x = np.repeat(rng.integers(0, 1024, (rows, gen))[..., None], 8, axis=2)
    lc = max(prompts)
    return (rng.integers(0, 32, (rows, text_len)), rng.integers(0, 1024, (rows, lc, 8)),
            np.full(rows, text_len), np.asarray(prompts), x, np.zeros((rows, gen), bool))


class _Rerun:
    """A stand-in graph: reruns the captured function into its output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def _fake_capture(fn, pool):
    out = fn()
    return _Rerun(fn, out), out


@pytest.fixture
def holders(monkeypatch):
    """Records the trajectories' holders; the counts start at 0."""
    from mars5_tts_torch.diffusion import engine
    from mars5_tts_torch.models import nar_graphs

    made = []

    class Recorded(nar_graphs.DecoderGraphs):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(engine, "DecoderGraphs", Recorded)
    nar_graphs.reset_counts()
    return made


def _on_cpu(monkeypatch):
    """The holder takes CPU calls, with the stand-in capture."""
    from mars5_tts_torch.models import nar_graphs as G
    from mars5_tts_torch.utils import cuda_graphs

    monkeypatch.setattr(G.DecoderGraphs, "takes",
                        lambda self, dec, x, mega, options: self.graphable(dec, mega, options))
    monkeypatch.setattr(cuda_graphs, "capture", _fake_capture)
    monkeypatch.setattr(cuda_graphs, "new_pool", lambda: None)
    monkeypatch.setattr(cuda_graphs, "on_side_stream", lambda device: contextlib.nullcontext())


def _run(nar, batch, dsh, options=None, **kw):
    from mars5_tts_torch.diffusion.engine import perform_simple_inference
    from mars5_tts_torch.diffusion.multinomial import MultinomialDiffusion
    from mars5_tts_torch.models.layers import DEFAULT_OPTIONS

    return perform_simple_inference(nar, batch, MultinomialDiffusion(K, STEPS), STEPS, dsh,
                                    generator=torch.Generator().manual_seed(4),
                                    options=options or DEFAULT_OPTIONS, **kw)


def _dsh(interval=(0.0, 0.5)):
    from mars5_tts_torch.config import DSH

    return DSH(x_0_temp=0.7, guidance_w=3.0, deep_clone=True, q0_override_steps=2,
               guidance_interval=interval)


def test_holder_stays_off_on_the_cpu(holders):
    from mars5_tts_torch.models import nar_graphs as G

    grid = _run(_nar(), _batch(np.random.default_rng(0)), _dsh())
    assert grid.shape == (1, 24, 8)
    assert len(holders) == 1 and holders[0]._geometries == {}
    assert G.graph_captures == G.graph_replays == 0


@pytest.mark.parametrize("sites", [("qkv", "caq", "ffn"), ("qkv", "caq"),
                                   ("qkv", "saout", "caq", "caout", "ffn")])
def test_graphed_trajectory_equals_eager(holders, monkeypatch, sites):
    """Deep clone, CFG over the first half of t: one geometry of bs rows (t
    runs down from T - 1, so it comes first) and one of 2 bs rows, each
    captured once and replayed at its other steps; the grid
    is the eager one bit for bit, for each site set (without ``"ffn"`` the
    stack is one segment)."""
    from mars5_tts_torch.models import nar_graphs as G
    from mars5_tts_torch.models.layers import NarOptions

    nar, batch, options = _nar(), _batch(np.random.default_rng(1)), NarOptions(sites=sites)
    want = _run(nar, batch, _dsh(), options)
    _on_cpu(monkeypatch)
    got = _run(nar, batch, _dsh(), options)
    assert torch.equal(got, want)
    geometries = holders[-1]._geometries
    assert [k[0][0] for k in geometries] == [1, 2]
    assert G.graph_captures == 2 and G.graph_replays == STEPS - 2
    assert {len(g.graphs) for g in geometries.values()} == (
        {len(nar.tfm.decoder.layers) + 1} if "ffn" in sites else {1})


def test_graphed_ragged_batch_equals_eager(holders, monkeypatch):
    """Two rows with their own prompt lengths (the whole grid through the
    decoder, q_tail_start 0), CFG at every step: one geometry."""
    from mars5_tts_torch.models import nar_graphs as G

    nar, batch = _nar(), _batch(np.random.default_rng(2), rows=2, prompts=(15, 11))
    want = _run(nar, batch, _dsh((0.0, 1.0)))
    _on_cpu(monkeypatch)
    got = _run(nar, batch, _dsh((0.0, 1.0)))
    assert torch.equal(got, want)
    assert [k[2] for k in holders[-1]._geometries] == [0]
    assert G.graph_captures == 1 and G.graph_replays == STEPS - 1


def test_graphed_fused_ffn_calls_stay_direct(holders, monkeypatch):
    """Each step still calls ``layers.fused_ffn`` once a layer (a reader
    that wraps it sees every call), the replays with ``out=`` the next
    segment's input."""
    from mars5_tts_torch.models import layers

    calls = []
    k4 = layers.fused_ffn

    def counted(*a, **kw):
        calls.append(kw.get("out") is not None)
        return k4(*a, **kw)

    monkeypatch.setattr(layers, "fused_ffn", counted)
    nar, batch = _nar(), _batch(np.random.default_rng(3))
    _run(nar, batch, _dsh())
    eager = len(calls)
    _on_cpu(monkeypatch)
    calls.clear()
    _run(nar, batch, _dsh())
    n_layers = len(nar.tfm.decoder.layers)
    assert len(calls) == eager == n_layers * STEPS
    assert sum(calls) == n_layers * (STEPS - 2)


def test_holder_refuses_masks_that_move(monkeypatch):
    from mars5_tts_torch.models.nar_graphs import DecoderGraphs

    _on_cpu(monkeypatch)
    nar = _nar()
    r = torch.Generator().manual_seed(0)
    x = torch.randint(0, 1024, (1, 20, 8), generator=r)
    t_dec = torch.randn(1, 64, generator=r).to(torch.bfloat16)
    memory = torch.randn(1, 7, 64, generator=r).to(torch.bfloat16)
    xpm, cpad = torch.zeros(1, 20, dtype=torch.bool), torch.zeros(1, 7, dtype=torch.bool)
    graphs = DecoderGraphs()
    with torch.inference_mode():
        first = nar.decoder_apply(x, xpm, t_dec, memory, cpad, graphs=graphs).clone()
        again = nar.decoder_apply(x, xpm, t_dec, memory, cpad, graphs=graphs)
        assert torch.equal(first, again)
        assert torch.equal(first, nar.decoder_apply(x, xpm, t_dec, memory, cpad))
        with pytest.raises(ValueError, match="storage"):
            nar.decoder_apply(x, xpm.clone(), t_dec, memory, cpad, graphs=graphs)


@pytest.mark.parametrize("case", ["graphed", "mega", "tp", "grad", "unquantized", "unfused"])
def test_graphable_predicate(case):
    """The graphs are off for K9, a tensor-parallel rank, autograd
    recording, an unquantized stack and the unfused W8A8 layer; on the CPU
    ``takes`` is off in every case."""
    from mars5_tts_torch.models.layers import DEFAULT_OPTIONS, NarOptions
    from mars5_tts_torch.models.nar import ResidualTransformer, ResidualTransformerConfig
    from mars5_tts_torch.models.nar_graphs import DecoderGraphs

    nar = (ResidualTransformer(ResidualTransformerConfig.tiny()) if case == "unquantized"
           else _nar())
    dec = nar.tfm.decoder
    mega = object() if case == "mega" else None
    options = NarOptions(fused=False) if case == "unfused" else DEFAULT_OPTIONS
    if case == "tp":
        dec.layers[-1].self_attn.tp = object()
    with torch.set_grad_enabled(case == "grad"):
        assert DecoderGraphs.graphable(dec, mega, options) == (case == "graphed")
        assert not DecoderGraphs().takes(dec, torch.zeros(1, 4, 8, dtype=torch.long), mega,
                                         options)


@pytest.mark.parametrize("free_gb,idle_gb,emptied", [(0.1, 30.0, True), (12.0, 30.0, True),
                                                    (60.0, 2.0, False), (3.0, 2.0, False)])
def test_new_pool_empties_the_cache_when_the_card_is_full(monkeypatch, free_gb, idle_gb,
                                                          emptied):
    """A capture allocates only from its own pool: where the card has less
    free than the default pool's cache holds idle (8 rows' encoder memory
    left cached), a new pool first empties that cache, and not otherwise."""
    from mars5_tts_torch.utils import cuda_graphs as C

    calls = []
    gib = 2 ** 30
    monkeypatch.setattr(C.torch.cuda, "mem_get_info", lambda *a: (int(free_gb * gib), 80 * gib))
    monkeypatch.setattr(C.torch.cuda, "memory_reserved", lambda *a: int((20 + idle_gb) * gib))
    monkeypatch.setattr(C.torch.cuda, "memory_allocated", lambda *a: 20 * gib)
    monkeypatch.setattr(C.torch.cuda, "empty_cache", lambda: calls.append("empty"))
    monkeypatch.setattr(C.torch.cuda, "MemPool", lambda: "pool")
    assert C.new_pool() == "pool"
    assert calls == (["empty"] if emptied else [])
