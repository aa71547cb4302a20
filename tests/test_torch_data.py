"""``mars5_tts_torch.data`` against ``mars5_tts_tpu.data``: the same seed
gives byte-identical corpora and batches."""

import numpy as np
import pytest

from mars5_tts_torch import data as P
from mars5_tts_tpu import data as J


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_corpus_byte_identical(seed):
    jc = J.synthetic_corpus(12, text_vocab=40, rng=np.random.default_rng(seed),
                            min_frames=10, max_frames=90, max_text=30)
    pc = P.synthetic_corpus(12, text_vocab=40, rng=np.random.default_rng(seed),
                            min_frames=10, max_frames=90, max_text=30)
    assert len(jc) == len(pc) == 12
    for ju, pu in zip(jc, pc):
        _same(ju.text_ids, pu.text_ids)
        _same(ju.codes, pu.codes)


@pytest.mark.parametrize("pads", [{}, dict(ar_pad_to=96, spk_pad_to=64, frames_pad_to=64,
                                           text_pad_to=24)])
def test_batches_byte_identical(pads):
    """Every (ar_batch, nar_batch) of an epoch, shuffled by the same seed,
    with and without fixed shapes."""
    corpus = J.synthetic_corpus(16, text_vocab=32)
    kw = dict(n_text_vocab_offset=32, eos_idx=900, seed=3, **pads)
    jb = list(J.batches(corpus, 4, **kw))
    pb = list(P.batches([P.Utterance(u.text_ids, u.codes) for u in corpus], 4, **kw))
    assert len(jb) == len(pb) == 4
    for (ja, jn), (pa, pn) in zip(jb, pb):
        for x, y in zip(ja + jn, pa + pn):
            _same(x, y)


def test_make_batches_byte_identical_ragged():
    rng = np.random.default_rng(1)
    utts = [J.Utterance(rng.integers(0, 50, n), rng.integers(0, 1024, (f, 8)))
            for n, f in ((3, 5), (7, 2), (1, 9))]
    putts = [P.Utterance(u.text_ids, u.codes) for u in utts]
    for x, y in zip(J.make_ar_batch(utts, 100, 999), P.make_ar_batch(putts, 100, 999)):
        _same(x, y)
    for x, y in zip(J.make_nar_batch(utts, pad_to=12, text_pad_to=8),
                    P.make_nar_batch(putts, pad_to=12, text_pad_to=8)):
        _same(x, y)
