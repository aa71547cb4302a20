"""The AR decode loop one step ahead (``models/ar_decode.decode_loop`` on a
``pipelined`` route) against the same route in series, on the CPU.

A pipelined route (the quantized engine's ``FusedStep``, here on K2's plain
twin, and the latent-attention ``LatentStep``) has step i + 1 launched
before step i is read back, K2 at cursors taken past the step in flight.
Its series twin is the same route with ``pipelined`` set False on its class
(the test patches the attribute): depth 0, the loop of the parent. At 1, 3
and 8 rows, with EOS forced at chosen steps in some rows (their logits put
all the mass on EOS there) and the others ended by ``max_len``, in one
call and in ``decode_chunk`` quanta of 1 and 7 steps, the tokens, generated
counts and penalty counts are the series loop's bit for bit, and so are
the rings of every row the speculation never ran ahead of. A one-row call
ended by its cap throws no step away; one ended by EOS throws away the one
step launched past it. The bf16 ring's route and the cacheless route stay
at depth 0, and a row with no finite logprob still raises out of the loop.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MAX_LEN = 40
FUSED_CFG = dict(n_vocab=512, dim=256, n_heads=4, n_kv_heads=4, head_dim=64, n_layers=3,
                 hidden_dim=512, sliding_window=24, n_spk_layers=2, spk_hidden_dim=256)
FUSED_SAMPLING = dict(temperature=0.9, top_k=50, top_p=0.9, n_phones_gen=30, eos_idx=509,
                      valid_start=10, valid_end=510, max_len=MAX_LEN)
LATENT_SAMPLING = dict(top_k=50, top_p=0.9, n_phones_gen=30, eos_idx=258 + 1024,
                       valid_start=258, valid_end=258 + 1025, max_len=MAX_LEN)


@functools.lru_cache(maxsize=None)
def _fused():
    """A three-layer AR (ring window 24, so the rings wrap) and its W4A8
    engine for up to 8 rows."""
    from mars5_tts_torch.models.ar import CodecLM, CodecLMConfig
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine, prepare_fused

    m = CodecLM(CodecLMConfig(**FUSED_CFG)).init_(torch.Generator().manual_seed(0)).eval()
    return m, FusedEngine(*prepare_fused(m, MAX_LEN, 4, batch=8))


@functools.lru_cache(maxsize=None)
def _latent():
    """A DeepSeek-V2-shaped AR (latent ring, experts) on the model's engine."""
    from tests.test_torch_mla_moe import _model

    from mars5_tts_torch.models.ar_decode import MODEL_ENGINE

    return _model(seed=2)[0], MODEL_ENGINE


def _setup(kind, rows, seed=0):
    """(model, engine, sampling, route class, prompts, speaker codes,
    uniforms (MAX_LEN, rows)) of ``kind``."""
    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F

    rng = np.random.default_rng(seed + rows)
    if kind == "fused":
        (model, engine), s, cls = _fused(), AD.ArSampling(**FUSED_SAMPLING), F.FusedStep
        prompts = [rng.integers(10, 510, n) for n in rng.integers(5, 18, rows)]
    else:
        (model, engine), s, cls = _latent(), AD.ArSampling(**LATENT_SAMPLING), AD.LatentStep
        prompts = [rng.integers(0, 258 + 1025, n) for n in rng.integers(5, 18, rows)]
    spks = [rng.integers(0, 1024, (n, 8)) for n in rng.integers(6, 20, rows)]
    u = torch.as_tensor(rng.random((MAX_LEN, rows)).astype(np.float32))
    return model, engine, s, cls, prompts, spks, u


def _decode(monkeypatch, kind, rows, at, quantum=None, serial=False, dead=None):
    """A call of ``rows`` rows on ``kind``'s route, each row drawing EOS at
    its ``at`` (0: ended by ``max_len``), in one ``decode_chunk`` or in
    quanta of ``quantum`` steps; with ``serial`` the route at depth 0.
    Returns (the state, pipelined_steps, discarded_steps)."""
    from mars5_tts_torch.models import ar_decode as AD

    from torch_port_fixtures import Forcing

    model, engine, s, cls, prompts, spks, u = _setup(kind, rows)
    engine = Forcing(engine, s.eos_idx, at, dead)
    with monkeypatch.context() as m:
        if serial:
            m.setattr(cls, "pipelined", False)
        AD.reset_counts()
        state = AD.prefill_state(model, s, prompts, spks, u, engine=engine)
        while not state.done.all():
            AD.decode_chunk(model, s, state, quantum, engine=engine)
        return state, AD.pipelined_steps, AD.discarded_steps


def _eos_steps(rows):
    """EOS at generated counts 4, 9, 14, ... in the even rows; the odd rows
    decode to ``max_len``."""
    return [0 if b % 2 else 4 + 5 * (b // 2) for b in range(rows)]


def _rings(state, kind, b):
    return ((state.cache.ckv[:, b],) if kind == "latent"
            else (state.cache.k[:, b], state.cache.v[:, b], state.cache.scales[:, b]))


@pytest.mark.parametrize("quantum", [None, 1, 7])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("kind", ["fused", "latent"])
@torch.no_grad()
def test_pipelined_loop_equals_the_series_loop(monkeypatch, kind, rows, quantum):
    """Tokens, generated counts, cursors and penalty counts bitwise the
    series loop's, and the rings of the rows that end at the cap (every
    row's on the latent route, whose cursor comes from the device); every
    launched step but each quantum's first launched ahead; one step thrown
    away only where an EOS ends a call mid-quantum."""
    at = _eos_steps(rows)
    got, n_pipe, n_drop = _decode(monkeypatch, kind, rows, at, quantum)
    want, n_pipe0, n_drop0 = _decode(monkeypatch, kind, rows, at, quantum, serial=True)
    for b, ((tg, ng), (tw, nw)) in enumerate(zip(got.results(), want.results())):
        np.testing.assert_array_equal(tg, tw, err_msg=f"row {b}")
        assert ng == nw, b
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert torch.equal(got.counts, want.counts)
    assert got.done.all() and (got.cur == want.cur).all()
    # the forced rows ended at EOS, the others at the cap
    for b, a in enumerate(at):
        assert (got.n_gen[b] == a) if a else (got.cur[b] == MAX_LEN), (b, got.n_gen[b])
    for b in range(rows):
        if kind == "latent" or not at[b]:          # never run ahead of its end
            for g, w in zip(_rings(got, kind, b), _rings(want, kind, b)):
                assert torch.equal(g, w), b
    assert (n_pipe0, n_drop0) == (0, 0)
    # a one-row call ended by EOS throws away the step launched past it,
    # unless its quantum ended there
    ahead = quantum is None or want.steps % quantum
    assert n_drop == int(rows == 1 and bool(ahead)) and got.steps == want.steps + n_drop
    chunks = 1 if quantum is None else -(-want.steps // quantum)
    assert n_pipe == got.steps - chunks                # all but each quantum's first


@pytest.mark.parametrize("end", ["cap", "eos"])
@pytest.mark.parametrize("kind", ["fused", "latent"])
@torch.no_grad()
def test_one_row_throws_away_a_step_only_past_its_eos(monkeypatch, kind, end):
    """One row in one call: every step after the first is launched ahead of
    the readback; ended by ``max_len`` no step is thrown away (the host
    knows the cap), ended by EOS the one step launched past it is."""
    at = [7 if end == "eos" else 0]
    got, n_pipe, n_drop = _decode(monkeypatch, kind, 1, at)
    want, _, _ = _decode(monkeypatch, kind, 1, at, serial=True)
    np.testing.assert_array_equal(got.results()[0][0], want.results()[0][0])
    assert n_drop == (end == "eos")
    assert got.steps == want.steps + n_drop and n_pipe == got.steps - 1
    assert got.n_gen[0] == (7 if end == "eos" else want.n_gen[0])


@torch.no_grad()
def test_k2_runs_one_step_past_an_eos_at_the_speculated_cursor(monkeypatch):
    """K2's cursors: the host's at the first step, then each live row's
    cursor + 1; the row that drew EOS runs the one step after it at its
    cursor + 1 (its result dropped), and its frozen cursor from the next
    on; the capped row runs to ``max_len - 1``."""
    from mars5_tts_torch.models import ar_decode_fused as F

    seen, real = [], F.FusedStep.direct
    monkeypatch.setattr(F.FusedStep, "direct",
                        lambda self, state, cur: seen.append(np.array(cur)) or real(self, state,
                                                                                   cur))
    at = [3, 0]
    got, _, n_drop = _decode(monkeypatch, "fused", 2, at)
    start = np.array([len(p) for p in _setup("fused", 2)[4]]) + 1   # after the first draw
    end0 = start[0] + at[0] - 1                       # row 0's cursor when it drew EOS
    k = np.arange(len(seen))
    row0 = np.where(k < at[0], start[0] + k, np.where(k == at[0], end0 + 1, end0))
    np.testing.assert_array_equal(np.stack(seen), np.stack([row0, start[1] + k], 1))
    assert (got.cur == [end0, MAX_LEN]).all() and seen[-1][1] == MAX_LEN - 1 and n_drop == 0


def test_ring_and_cacheless_routes_stay_in_series():
    """The bf16 ring (``RingStep``: K7 sizes its clusters from the host's
    positions) and ``NoCacheStep`` read host fields: not pipelined; a call
    on the ring launches no step ahead and throws none away."""
    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F

    assert not AD.RingStep.pipelined and not AD.NoCacheStep.pipelined
    assert F.FusedStep.pipelined and AD.LatentStep.pipelined
    model, _, s, _, prompts, spks, u = _setup("fused", 3)
    AD.reset_counts()
    out = AD.ar_generate_batched(model, prompts, spks, sampling=s, uniforms=u.numpy())
    assert len(out) == 3 and (AD.pipelined_steps, AD.discarded_steps) == (0, 0)


@pytest.mark.parametrize("where", ["draw", "readback"])
@pytest.mark.parametrize("kind", ["fused", "latent"])
@torch.no_grad()
def test_dead_row_raises_out_of_the_pipelined_loop(monkeypatch, kind, where):
    """A row whose logits turn all -inf at its fourth generated token (its
    fourth decode step) raises the sampler's ``ValueError`` out of
    ``decode_loop``: at the draw, or, with the draw's check off (as in a
    CUDA graph, where the row draws -1), at that step's readback, once the
    next step is launched."""
    from mars5_tts_torch.models import ar_decode as AD

    if where == "readback":
        real = AD.sample_from_logprobs

        def unchecked(lp, u):
            live = torch.isfinite(lp).any(dim=-1)
            return torch.where(live, real(torch.where(live[:, None], lp, 0.0), u), -1)

        monkeypatch.setattr(AD, "sample_from_logprobs", unchecked)
    with pytest.raises(ValueError, match="no finite logprob"):
        _decode(monkeypatch, kind, 2, [0, 0], dead=[0, 4])
    # steps 1 and 2 were launched ahead; by the readback, steps 3 and 4 too
    assert AD.pipelined_steps == (2 if where == "draw" else 4)


def test_readback_event_is_recorded_on_the_stream_of_the_state_card(monkeypatch):
    """``DeviceState.post`` queues the copy of ``out`` on the current stream
    of the card that holds ``out``, and records its event on that stream,
    not on the current card's: a model on a card other than the current one
    then waits for its own copy. Checked on the CPU with a stand-in event and
    stream; ``tests/test_torch_cuda.py`` checks it on two cards."""
    from mars5_tts_torch.models.ar_decode import DeviceState

    state = DeviceState(2, 8, "cpu")
    asked, recorded = [], []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: asked.append(device) or ("stream of", device))
    state.copied = [Event(), Event()]
    state.out.copy_(torch.tensor([[5, 0], [7, 1]]))
    state.post(1)
    assert asked == [state.out.device] and recorded == [("stream of", state.out.device)]
    np.testing.assert_array_equal(state.fetch(1), [[5, 0], [7, 1]])
