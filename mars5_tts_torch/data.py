"""Training data: paired (text, codec codes) batches for the AR and the NAR
(counterpart of ``mars5_tts_tpu/data.py``, numpy only, kept as the port's
own copy).

Host-side numpy batching with optional fixed (bucketed) shapes and the
prompt layout the models were trained on (AR: ``text ++ offset speech
codes`` with the loss masked to the acoustic region; NAR: clean 8-codebook
grids with padding masks). For one seed the batches are byte-identical to
the JAX package's; ``train.py`` moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass
class Utterance:
    """One training example: BPE text ids + (frames, 8) codec codes."""

    text_ids: np.ndarray
    codes: np.ndarray  # (frames, 8) int


def synthetic_corpus(n: int, text_vocab: int, rng=None, min_frames: int = 20,
                     max_frames: int = 60, max_text: int = 24) -> list[Utterance]:
    """Learnable toy corpus for smoke training runs / tests.

    Codes follow a per-utterance arithmetic pattern (next-token predictable from
    the previous one), so the AR/NAR losses measurably decrease within a few
    dozen steps.
    """
    rng = rng or np.random.default_rng(0)
    out = []
    for _ in range(n):
        lt = int(rng.integers(4, max_text))
        lf = int(rng.integers(min_frames, max_frames))
        start = int(rng.integers(0, 16))
        stride = int(rng.integers(1, 4))
        base = (start + stride * np.arange(lf)) % 32
        codes = (base[:, None] + np.arange(8)[None, :] * 3) % 32
        out.append(Utterance(
            text_ids=rng.integers(0, text_vocab, lt),
            codes=codes.astype(np.int64)))
    return out


def make_ar_batch(utts: Sequence[Utterance], n_text_vocab_offset: int,
                  eos_idx: int, pad_to: int | None = None,
                  spk_pad_to: int | None = None):
    """AR batch: tokens (bs, L), loss_mask (bs, L-1), spk_codes (bs, S, 8).

    Sequence = text ids ++ (codes L0 + offset) ++ eos, right-padded with eos.
    Loss covers the acoustic region + eos (teacher forcing predicts position
    i+1 from i), matching the inference-time ``first_codec_idx`` convention.
    The speaker reference is the utterance's own codes (as in self-supervised
    voice-cloning training).
    """
    seqs, masks = [], []
    for u in utts:
        speech = u.codes[:, 0] + n_text_vocab_offset
        seq = np.concatenate([u.text_ids, speech, [eos_idx]])
        mask = np.zeros(len(seq) - 1, np.float32)
        mask[len(u.text_ids) - 1:] = 1.0  # predict first speech token onward
        seqs.append(seq)
        masks.append(mask)
    max_l = pad_to or max(len(s) for s in seqs)
    bs = len(seqs)
    tokens = np.full((bs, max_l), eos_idx, np.int32)
    loss_mask = np.zeros((bs, max_l - 1), np.float32)
    for i, (s, m) in enumerate(zip(seqs, masks)):
        tokens[i, : len(s)] = s
        loss_mask[i, : len(m)] = m

    max_s = spk_pad_to or max(u.codes.shape[0] for u in utts)
    spk = np.full((bs, max_s, 8), 1024, np.int32)  # pad idx
    for i, u in enumerate(utts):
        spk[i, : u.codes.shape[0]] = u.codes
    return tokens, loss_mask, spk


def make_nar_batch(utts: Sequence[Utterance], pad_to: int | None = None,
                   text_pad_to: int | None = None):
    """NAR batch: (c_text, c_codes, c_texts_length, c_codes_length, x0, x_padding_mask)."""
    bs = len(utts)
    lt = text_pad_to or max(len(u.text_ids) for u in utts)
    lf = pad_to or max(u.codes.shape[0] for u in utts)
    c_text = np.zeros((bs, lt), np.int32)
    ctl = np.zeros((bs,), np.int32)
    c_codes = np.full((bs, lf, 8), 1024, np.int32)
    ccl = np.zeros((bs,), np.int32)
    x0 = np.zeros((bs, lf, 8), np.int32)
    xpm = np.ones((bs, lf), bool)
    for i, u in enumerate(utts):
        c_text[i, : len(u.text_ids)] = u.text_ids
        ctl[i] = len(u.text_ids)
        n = u.codes.shape[0]
        c_codes[i, :n] = u.codes
        ccl[i] = n
        x0[i, :n] = u.codes
        xpm[i, :n] = False
    return c_text, c_codes, ctl, ccl, x0, xpm


def batches(corpus: Sequence[Utterance], batch_size: int, *, seed: int = 0,
            n_text_vocab_offset: int, eos_idx: int,
            ar_pad_to: int | None = None, spk_pad_to: int | None = None,
            frames_pad_to: int | None = None,
            text_pad_to: int | None = None) -> Iterator[tuple]:
    """Shuffled epoch iterator yielding (ar_batch, nar_batch) pairs.

    Buckets by length (sorted order + shuffled bucket starts) so padded shapes
    stay tight; shapes still vary across buckets unless the ``*_pad_to``
    sizes fix them.
    """
    rng = np.random.default_rng(seed)
    order = np.argsort([u.codes.shape[0] for u in corpus])
    starts = list(range(0, len(order) - batch_size + 1, batch_size))
    rng.shuffle(starts)
    for s in starts:
        utts = [corpus[i] for i in order[s:s + batch_size]]
        yield (make_ar_batch(utts, n_text_vocab_offset, eos_idx,
                             pad_to=ar_pad_to, spk_pad_to=spk_pad_to),
               make_nar_batch(utts, pad_to=frames_pad_to, text_pad_to=text_pad_to))
