"""The AR decode step's device-side sampler and its CUDA graphs
(``models/ar_graphs.py``) on the CPU.

* The early-EOS table a state keeps on the device holds, at each generated
  count, what ``early_eos_penalty`` subtracts there, bit for bit.
* A batched decode whose rows each carry their own sampling values (penalty
  windows, top-k, top-p, typical-p, early-EOS decay and factor), one row
  ending at EOS while the others decode on: each row's tokens are its solo
  run's and the JAX pool's on the same uniforms.
* A row with no finite logprob raises the sampler's ``ValueError`` through
  the decode loop, at the draw or, where the draw cannot check (a CUDA
  graph), at the readback.
* CUDA graphs need a card, so on the CPU nothing is captured. The holder's
  own work (one capture a geometry, the static buffers, the device state
  carried from step to step and across a pool's inserts) is held to the
  eager loop bit for bit with the capture swapped, in the test only, for a
  stand-in that reruns the captured function at each replay. The card's
  graphs are held to the eager loop in ``tests/test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tests.torch_port_fixtures import port_codeclm  # noqa: E402

SAMPLING = dict(temperature=0.7, top_k=10, top_p=0.9, typical_p=1.0, alpha_frequency=1.0,
                alpha_presence=0.4, penalty_window=5, eos_penalty_decay=0.5,
                eos_penalty_factor=1.0, n_phones_gen=8, eos_idx=49, valid_start=20,
                valid_end=51, max_len=48)
ROWS = [{"temperature": 1.3, "top_k": 5, "penalty_window": 3},
        {"top_p": 0.5, "alpha_frequency": 2.5, "penalty_window": 9},
        {"typical_p": 0.8, "penalty_window": 1, "eos_penalty_decay": 0.3},
        {"eos_penalty_factor": 2.5, "eos_penalty_decay": 1.7, "penalty_window": 0}]


@functools.lru_cache(maxsize=None)
def tiny_ar():
    """The JAX continuous tests' AR: config, params and the port's CodecLM."""
    from mars5_tts_tpu.models.ar import CodecLMConfig, init_codeclm

    cfg = CodecLMConfig.tiny(n_vocab=50)
    params = jax.tree.map(np.asarray, init_codeclm(jax.random.PRNGKey(0), cfg))
    return cfg, params, port_codeclm(cfg, params)


def _case(seed, n=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 20, k) for k in (9, 5, 11, 6)[:n]]
    spks = [rng.integers(0, 1024, (4, 8)) for _ in prompts]
    us = [rng.random(SAMPLING["max_len"]).astype(np.float32) for _ in prompts]
    return prompts, spks, us


def _rows(s, overrides):
    from mars5_tts_torch.models.ar_decode import ROW_FIELDS, RowSampling, rows_from_sampling

    one = [rows_from_sampling(s, 1, o) for o in overrides]
    return RowSampling(**{n: np.concatenate([getattr(r, n) for r in one]) for n in ROW_FIELDS})


# ------------------------------------------------------------ the sampler

@pytest.mark.parametrize("factor", [1.0, 2.5])
@pytest.mark.parametrize("decay", [0.5, 0.3, 1.7])
def test_early_eos_table_is_early_eos_penalty(decay, factor):
    from mars5_tts_torch.ops.sampling import early_eos_penalty, early_eos_table

    n, ests = 305, np.arange(301)
    est, gen = np.repeat(ests, n + 1), np.tile(np.arange(n + 1), len(ests))
    want = -early_eos_penalty(torch.zeros((len(est), 2)), gen, est, decay, factor, 1)[:, 1]
    got = torch.cat([early_eos_table(int(e), decay, factor, n) for e in ests])
    assert torch.equal(got, want)
    assert bool((got[gen <= est] > 0).all()) and not got[gen > est].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_rows_equal_solo_runs_and_jax(seed):
    """Four rows, each with its own sampling values, through the batched
    engine: each row's tokens are its solo run's and the JAX pool's (whose
    rows carry the same values); one row ends at EOS while others decode."""
    from mars5_tts_tpu.models.ar_decode import ArSampling as JS
    from mars5_tts_tpu.serving.continuous import ContinuousBatcher as JBatcher
    from mars5_tts_tpu.serving.continuous import Request as JRequest
    from mars5_tts_torch.models.ar_decode import (ArSampling, ar_generate_batched,
                                                  rows_from_sampling)

    cfg, params, model = tiny_ar()
    prompts, spks, us = _case(seed)
    s = ArSampling(**SAMPLING)
    got = ar_generate_batched(model, prompts, spks, sampling=s, uniforms=np.stack(us, 1),
                              rows=_rows(s, ROWS))
    jpool = JBatcher(params, cfg, JS(**SAMPLING), batch_size=4, chunk_steps=7,
                     prompt_buckets=(16,), spk_bucket=16)
    jreqs = [jpool.submit(JRequest(prompt=p, spk_codes=k, uniforms=u, sampling=o))
             for p, k, u, o in zip(prompts, spks, us, ROWS)]
    jpool.run()
    for i, ((tok, n), jreq) in enumerate(zip(got, jreqs)):
        (solo, n_solo), = ar_generate_batched(model, [prompts[i]], [spks[i]], sampling=s,
                                              uniforms=us[i],
                                              rows=rows_from_sampling(s, 1, ROWS[i]))
        np.testing.assert_array_equal(tok, solo, err_msg=f"row {i} solo")
        np.testing.assert_array_equal(tok, np.asarray(jreq.tokens), err_msg=f"row {i} JAX")
        assert n == n_solo == jreq.n_gen
    lens = [len(t) for t, _ in got]
    assert min(lens) < s.max_len and min(lens) < max(lens)


@pytest.mark.parametrize("where", ["draw", "readback"])
def test_dead_row_raises_through_the_decode_loop(monkeypatch, where):
    """A row whose logits are all -inf raises at the draw; with the draw's
    own check off (as while a graph captures it, where the row draws -1) the
    readback raises the same error."""
    from mars5_tts_torch.models import ar_decode as AD

    cfg, _, model = tiny_ar()
    prompts, spks, us = _case(0, 2)
    s = AD.ArSampling(**SAMPLING)
    state = AD.prefill_state(model, s, prompts, spks, torch.as_tensor(np.stack(us, 1)))
    if where == "readback":
        monkeypatch.setattr(AD, "sample_from_logprobs",
                            lambda lp, u: torch.full(u.shape, -1, dtype=torch.int64))

    class Dead(AD.Route):
        def body(self, state):
            logits = torch.zeros((2, cfg.n_vocab))
            logits[1] = float("-inf")
            return logits

    with pytest.raises(ValueError, match="no finite logprob"):
        AD.decode_loop(state, s, AD.rows_from_sampling(s, 2), Dead())


# ------------------------------------------------------------ the graphs

class _Rerun:
    """A stand-in graph: reruns the captured function."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """The holder takes CPU steps, with the stand-in capture; the counts
    start at 0."""
    from mars5_tts_torch.models import ar_graphs as G
    from mars5_tts_torch.utils import cuda_graphs

    monkeypatch.setattr(G, "takes", lambda state, route: route.graphable)
    monkeypatch.setattr(cuda_graphs, "capture", lambda fn, pool: (_Rerun(fn), None))
    monkeypatch.setattr(cuda_graphs, "on_side_stream", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(cuda_graphs, "new_pool", lambda: object())
    G.reset_counts()
    return G


def _fused(wbits):
    from tests.test_torch_fused_decode import CFG, MAX_LEN, SAMPLING as FS, models

    from mars5_tts_torch.models.ar_decode import ArSampling
    from mars5_tts_torch.models.ar_decode_fused import prepare_fused

    model = models()[1]
    fp, dims = prepare_fused(model, MAX_LEN, wbits, batch=4)
    rng = np.random.default_rng(wbits)
    prompts = [rng.integers(10, 510, n) for n in (5, 17, 7, 12)]
    spks = [rng.integers(0, 1024, (n, 8)) for n in (20, 9, 14, 6)]
    us = rng.random((MAX_LEN, 4)).astype(np.float32)
    return model, fp, dims, ArSampling(**FS), prompts, spks, us, CFG


@pytest.mark.parametrize("wbits", [8, 4])
def test_graphed_fused_rows_equal_eager_and_solo(stand_in, monkeypatch, wbits):
    """Four rows on the quantized engine with their own sampling values:
    the stand-in graphs give the eager loop's tokens, each row its solo
    run's; one capture for the call, a replay at every later step, K2 a
    direct call each step."""
    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F

    model, fp, dims, s, prompts, spks, us, _ = _fused(wbits)
    rows = _rows(s, [{"top_k": 7, "penalty_window": 2}, {"top_p": 0.9, "temperature": 1.2},
                     {"typical_p": 0.7, "eos_penalty_decay": 0.3}, {"penalty_window": 0}])
    k2, states = [], []
    real = F.fused_decode_layers
    monkeypatch.setattr(F, "fused_decode_layers", lambda *a, **k: k2.append(1) or real(*a, **k))
    loop = AD.decode_loop
    monkeypatch.setattr(AD, "decode_loop", lambda st, *a, **k: states.append(st) or loop(st, *a, **k))
    engine = F.FusedEngine(fp, dims)

    def run():
        return AD.ar_generate_batched(model, prompts, spks, sampling=s, uniforms=us, rows=rows,
                                      est_lens=[3, 0, 20, 9], engine=engine)

    graphed = run()
    steps = states[-1].steps
    assert (stand_in.graph_captures, stand_in.graph_replays) == (1, steps - 1)
    assert len(k2) == steps and states[-1].graphs is not None
    with monkeypatch.context() as m:
        m.setattr(stand_in, "takes", lambda state, route: False)
        eager = run()
    assert states[-1].graphs is None
    for i, ((tg, ng), (te, ne)) in enumerate(zip(graphed, eager)):
        np.testing.assert_array_equal(tg, te, err_msg=f"row {i}")
        assert ng == ne
        one = AD.ar_generate_batched(
            model, [prompts[i]], [spks[i]], sampling=s, uniforms=us[:, i],
            est_lens=[[3, 0, 20, 9][i]],
            rows=AD.RowSampling(**{n: getattr(rows, n)[i:i + 1] for n in AD.ROW_FIELDS}),
            engine=F.FusedEngine(fp, dataclasses.replace(dims, batch=1)))
        np.testing.assert_array_equal(tg, one[0][0], err_msg=f"row {i} solo")


def test_graphed_fused_pool_keeps_its_graph_across_inserts(stand_in):
    """A four-row ``ContinuousBatcher`` on the quantized engine over six
    requests: its inserts write the device state in place, so one capture
    serves the pool, every other step replays, and each request's tokens
    are its solo run's."""
    from tests.test_torch_serving import _fused_requests

    from mars5_tts_torch.models.ar_decode import ar_generate
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine
    from mars5_tts_torch.serving import ContinuousBatcher, Request

    model, fp, dims, s, *_ = _fused(4)
    prompts, spks, us = _fused_requests(3)
    prompts, spks, us = prompts + prompts[:1], spks + spks[:1], us + us[-1:]
    engine = FusedEngine(fp, dims)
    pool = ContinuousBatcher(model, s, engine=engine, batch_size=4, chunk_steps=5,
                             prompt_buckets=(8, 20), spk_bucket=32)
    reqs = [pool.submit(Request(prompt=p, spk_codes=k, uniforms=u))
            for p, k, u in zip(prompts, spks, us)]
    pool.run()
    assert pool.chunks_run > 2
    assert (stand_in.graph_captures, stand_in.graph_replays) == (1, pool.steps_run - 1)
    for i, (req, p, k, u) in enumerate(zip(reqs, prompts, spks, us)):
        ref, n_ref = ar_generate(model, p, k, sampling=s, uniforms=u, engine=engine)
        np.testing.assert_array_equal(req.tokens, ref, err_msg=f"request {i}")
        assert req.n_gen == n_ref
    assert stand_in.graph_captures == 1 + len(reqs)      # one a solo call


def test_nothing_is_captured_off_the_card():
    """On the CPU every route runs eagerly: no holder, no capture."""
    from mars5_tts_torch.models import ar_graphs as G
    from mars5_tts_torch.models.ar_decode import ar_generate_batched
    from mars5_tts_torch.models.ar_decode_fused import FusedEngine

    G.reset_counts()
    model, fp, dims, s, prompts, spks, us, _ = _fused(4)
    out = ar_generate_batched(model, prompts, spks, sampling=s, uniforms=us,
                              engine=FusedEngine(fp, dims))
    assert len(out) == 4 and (G.graph_captures, G.graph_replays) == (0, 0)


def test_dp_decoder_on_a_latent_cache_captures_once(stand_in, monkeypatch, tmp_path):
    """``ShardedARDecoder`` (dp 1) over a DeepSeek-V2-shaped AR steps its
    latent ring as ``ar_generate_batched`` does: one capture for the call, a
    replay at every later step, and the eager loop's tokens."""
    import torch.distributed as dist

    from tests.test_torch_mla_moe import _inputs, _model

    from mars5_tts_torch.models import ar_decode as AD
    from mars5_tts_torch.parallel import make_mesh
    from mars5_tts_torch.serving.multichip import ShardedARDecoder

    m, _, _ = _model(seed=2)
    s = AD.ArSampling(max_len=40, valid_start=258, valid_end=258 + 1025, eos_idx=258 + 1024,
                      top_k=50, top_p=0.9)
    toks, spk = _inputs(n_tok=12)
    prompts, spks = [toks[:12].numpy(), toks[:9].numpy()], [spk.numpy()] * 2
    u = np.random.default_rng(3).random((2, s.max_len)).astype(np.float32)
    states, loop = [], AD.decode_loop
    monkeypatch.setattr(AD, "decode_loop",
                        lambda st, *a, **k: states.append(st) or loop(st, *a, **k))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        got = ShardedARDecoder(m, s, mesh=make_mesh(tp=1)).generate(prompts, spks,
                                                                  uniforms=list(u))
    finally:
        dist.destroy_process_group()
    assert isinstance(states[-1].cache, AD.LatentCache)
    steps = states[-1].steps
    assert steps > 1 and (stand_in.graph_captures, stand_in.graph_replays) == (1, steps - 1)
    monkeypatch.setattr(stand_in, "takes", lambda state, route: False)
    want = AD.ar_generate_batched(m, prompts, spks, sampling=s, uniforms=u.T)
    for (tg, ng), (te, ne) in zip(got, want):
        np.testing.assert_array_equal(tg, te)
        assert ng == ne


@pytest.mark.parametrize("wbits", [8, 4])
def test_graphed_fused_steps_run_one_ahead(stand_in, monkeypatch, wbits):
    """The stand-in graphs on the quantized route, launched one step ahead
    of the readback: the tokens and counts of the same graphed route in
    series (``FusedStep.pipelined`` patched False); one capture, a replay and
    a K2 call at every later step launched, each but the first launched
    ahead, at most one thrown away."""
    from mars5_tts_torch.models import ar_decode as AD, ar_decode_fused as F

    model, fp, dims, s, prompts, spks, us, _ = _fused(wbits)
    k2, runs = [], []
    real = F.fused_decode_layers
    monkeypatch.setattr(F, "fused_decode_layers", lambda *a, **k: k2.append(1) or real(*a, **k))
    for serial in (False, True):
        with monkeypatch.context() as m:
            if serial:
                m.setattr(F.FusedStep, "pipelined", False)
            AD.reset_counts()
            k2.clear()
            state = AD.prefill_state(model, s, prompts, spks, torch.as_tensor(us),
                                     est_lens=[3, 0, 20, 9], engine=F.FusedEngine(fp, dims))
            AD.decode_chunk(model, s, state, None, engine=F.FusedEngine(fp, dims))
            runs.append((state, AD.pipelined_steps, AD.discarded_steps, len(k2),
                         stand_in.graph_captures, stand_in.graph_replays))
    (got, pipe, drop, n_k2, cap, rep), (want, pipe0, drop0, n_k20, cap0, rep0) = runs
    for (tg, ng), (tw, nw) in zip(got.results(), want.results()):
        np.testing.assert_array_equal(tg, tw)
        assert ng == nw
    assert torch.equal(got.counts, want.counts)
    assert (pipe0, drop0, n_k20, cap0, rep0) == (0, 0, want.steps, 1, want.steps - 1)
    assert drop <= 1 and got.steps == want.steps + drop
    assert (pipe, n_k2, cap, rep) == (got.steps - 1, got.steps, 1, got.steps - 1)
