"""Byte-pair-encoding tokenizers, wire-compatible with the "minbpe v1" model format.

The original MARS5 (``mars5/minbpe/{base,regex,codebook}.py``) ships two BPE
tokenizers whose serialized vocabularies are embedded in the MARS5 checkpoint
metadata:

* ``RegexTokenizer`` — GPT-4-style byte-level BPE over text
  (reference: mars5/minbpe/regex.py:22-164),
* ``CodebookTokenizer`` — BPE over integer Encodec L0 codes rendered as
  space-joined 4-digit decimal strings (reference: mars5/minbpe/codebook.py:13-216).

Both must reproduce the reference's encode/decode results exactly: the AR model's
vocabulary ids are ``text ids ++ speech ids`` and any divergence breaks token parity.

This implementation is written fresh, with a faster merge loop: instead of the
reference's O(n^2) repeated full-scan (minbpe/base.py:26-42 ``merge`` called once per
merge), we run a single linked-list + heap pass that applies all merges in
lowest-rank-first order in O(n log n). The results are identical because greedy BPE
with a total ordering of merge ranks is confluent for this selection rule (always
merge the lowest-rank pair present, left-most first).
"""

from __future__ import annotations

import heapq
import io
import unicodedata

import regex as re

from . import native as _native

# GPT-4 text split pattern (see tiktoken's openai_public.py; same constant the
# reference uses at mars5/minbpe/regex.py:19).
GPT4_SPLIT_PATTERN = r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""


def _merge_ids(ids: list[int], ranks: dict[tuple[int, int], int]) -> list[int]:
    """Apply all BPE merges to ``ids`` greedily by lowest merge rank.

    Equivalent to the reference loop (minbpe/regex.py:92-109): repeatedly find the
    pair with the lowest merge index and fuse every occurrence left-to-right.
    Implemented as a doubly-linked list with a lazy heap of candidate pairs.
    """
    n = len(ids)
    if n < 2:
        return list(ids)

    ids = list(ids)
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n

    heap: list[tuple[int, int]] = []
    for i in range(n - 1):
        r = ranks.get((ids[i], ids[i + 1]))
        if r is not None:
            heap.append((r, i))
    heapq.heapify(heap)

    while heap:
        rank, i = heapq.heappop(heap)
        if not alive[i]:
            continue
        j = nxt[i]
        if j == -1 or not alive[j]:
            continue
        if ranks.get((ids[i], ids[j])) != rank:
            continue  # stale entry: one side already merged into something else
        # fuse (i, j) -> new token stored at i
        ids[i] = rank  # rank IS the new token id (ranks map pair -> minted id)
        alive[j] = False
        k = nxt[j]
        nxt[i] = k
        if k != -1:
            prv[k] = i
            r = ranks.get((ids[i], ids[k]))
            if r is not None:
                heapq.heappush(heap, (r, i))
        p = prv[i]
        if p != -1 and alive[p]:
            r = ranks.get((ids[p], ids[i]))
            if r is not None:
                heapq.heappush(heap, (r, p))

    return [ids[i] for i in range(n) if alive[i]]


def _replace_control_characters(s: str) -> str:
    out = []
    for ch in s:
        if unicodedata.category(ch)[0] != "C":
            out.append(ch)
        else:
            out.append(f"\\u{ord(ch):04x}")
    return "".join(out)


def render_token(t: bytes) -> str:
    """Printable rendering of a token's bytes (for .vocab dumps)."""
    return _replace_control_characters(t.decode("utf-8", errors="replace"))


class Tokenizer:
    """Base tokenizer holding merges/pattern/specials, with minbpe-v1 save/load.

    File format (reference: mars5/minbpe/base.py:98-170): a ``minbpe v1`` version
    line, the split pattern, the special-token count followed by ``<tok> <id>``
    lines, then one ``<id1> <id2>`` line per merge; minted ids start at
    ``self._base_vocab_size()`` and increase by one per line.
    """

    def __init__(self):
        self.merges: dict[tuple[int, int], int] = {}
        self.pattern: str = ""
        self.special_tokens: dict[str, int] = {}
        self.inverse_special_tokens: dict[int, str] = {}
        self.vocab: dict[int, bytes] = self._build_vocab()

    # -- subclass hooks -----------------------------------------------------
    def _base_vocab_size(self) -> int:
        return 256

    def _base_vocab(self) -> dict[int, bytes]:
        return {i: bytes([i]) for i in range(256)}

    # -- shared machinery ---------------------------------------------------
    def _build_vocab(self) -> dict[int, bytes]:
        vocab = self._base_vocab()
        for (a, b), idx in self.merges.items():
            vocab[idx] = vocab[a] + vocab[b]
        for special, idx in self.special_tokens.items():
            vocab[idx] = special.encode("utf-8")
        return vocab

    def register_special_tokens(self, special_tokens: dict[str, int]) -> None:
        self.special_tokens = dict(special_tokens)
        self.inverse_special_tokens = {v: k for k, v in special_tokens.items()}
        self.vocab = self._build_vocab()

    def decode(self, ids) -> str:
        parts = []
        for idx in ids:
            if idx in self.vocab:
                parts.append(self.vocab[idx])
            elif idx in self.inverse_special_tokens:
                parts.append(self.inverse_special_tokens[idx].encode("utf-8"))
            else:
                raise ValueError(f"invalid token id: {idx}")
        return b"".join(parts).decode("utf-8", errors="replace")

    def save(self, file_prefix: str) -> None:
        with open(file_prefix + ".model", "w") as f:
            f.write("minbpe v1\n")
            f.write(f"{self.pattern}\n")
            f.write(f"{len(self.special_tokens)}\n")
            for special, idx in self.special_tokens.items():
                f.write(f"{special} {idx}\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")
        inverted = {idx: pair for pair, idx in self.merges.items()}
        with open(file_prefix + ".vocab", "w", encoding="utf-8") as f:
            for idx, token in self.vocab.items():
                s = render_token(token)
                if idx in inverted:
                    a, b = inverted[idx]
                    f.write(f"[{render_token(self.vocab[a])}][{render_token(self.vocab[b])}] -> [{s}] {idx}\n")
                else:
                    f.write(f"[{s}] {idx}\n")

    def load(self, model_file) -> None:
        if isinstance(model_file, io.BytesIO):
            f = io.TextIOWrapper(model_file, encoding="utf-8")
        else:
            path = str(model_file)
            assert path.endswith(".model"), f"expected a .model file, got {path}"
            f = open(path, encoding="utf-8")
        with f:
            version = f.readline().strip()
            assert version == "minbpe v1", f"unsupported model version: {version!r}"
            self.pattern = f.readline().strip()
            num_special = int(f.readline().strip())
            special_tokens = {}
            for _ in range(num_special):
                name, idx = f.readline().strip().split()
                special_tokens[name] = int(idx)
            merges = {}
            idx = self._base_vocab_size()
            for line in f:
                a, b = map(int, line.split())
                merges[(a, b)] = idx
                idx += 1
        self.merges = merges
        self.special_tokens = special_tokens
        self.inverse_special_tokens = {v: k for k, v in special_tokens.items()}
        self.vocab = self._build_vocab()

    # -- training (shared greedy most-frequent-pair loop) --------------------
    def _train_chunks(self, chunks: list[list[int]], num_merges: int,
                      base_vocab: dict[int, bytes], first_id: int, verbose: bool):
        merges: dict[tuple[int, int], int] = {}
        vocab = dict(base_vocab)
        ids = [list(c) for c in chunks]
        for i in range(num_merges):
            stats: dict[tuple[int, int], int] = {}
            for chunk in ids:
                for pair in zip(chunk, chunk[1:]):
                    stats[pair] = stats.get(pair, 0) + 1
            if not stats:
                break
            pair = max(stats, key=stats.get)
            idx = first_id + i
            merges[pair] = idx
            vocab[idx] = vocab[pair[0]] + vocab[pair[1]]
            one = {pair: idx}
            ids = [_merge_ids(chunk, one) for chunk in ids]
            if verbose:
                print(f"merge {i + 1}/{num_merges}: {pair} -> {idx} ({vocab[idx]}) had {stats[pair]} occurrences")
        self.merges = merges
        self.vocab = vocab

    # -- special-token-aware encode ------------------------------------------
    def encode(self, text: str, allowed_special="none_raise") -> list[int]:
        if allowed_special == "all":
            special = self.special_tokens
        elif allowed_special == "none":
            special = {}
        elif allowed_special == "none_raise":
            special = {}
            assert all(tok not in text for tok in self.special_tokens)
        elif isinstance(allowed_special, set):
            special = {k: v for k, v in self.special_tokens.items() if k in allowed_special}
        else:
            raise ValueError(f"allowed_special={allowed_special} not understood")
        if not special:
            return self.encode_ordinary(text)
        special_pattern = "(" + "|".join(re.escape(k) for k in special) + ")"
        ids: list[int] = []
        for part in re.split(special_pattern, text):
            part = self._preprocess_special_chunk(part)
            if part is None:
                continue
            if part in special:
                ids.append(special[part])
            else:
                ids.extend(self.encode_ordinary(part))
        return ids

    def _preprocess_special_chunk(self, part: str):
        return part

    def _merge(self, ids) -> list[int]:
        """Apply merges: native C++ engine for long sequences, Python otherwise."""
        if len(ids) < 2 or not self.merges:
            return list(ids)
        if len(ids) >= 32 and _native.available():
            table = getattr(self, "_native_table", None)
            if table is None or getattr(self, "_native_src", None) is not self.merges:
                self._native_table = table = _native.MergeTable(self.merges)
                self._native_src = self.merges
            return _native.merge_ids_native(ids, table)
        return _merge_ids(ids, self.merges)

    def encode_ordinary(self, text: str) -> list[int]:
        raise NotImplementedError


class RegexTokenizer(Tokenizer):
    """GPT-4-style byte-level BPE over text (reference: mars5/minbpe/regex.py)."""

    def __init__(self, pattern: str | None = None):
        super().__init__()
        self.pattern = GPT4_SPLIT_PATTERN if pattern is None else pattern
        self.compiled_pattern = re.compile(self.pattern)

    def train(self, text: str, vocab_size: int, verbose: bool = False) -> None:
        assert vocab_size >= 256
        chunks = [list(ch.encode("utf-8")) for ch in re.findall(self.compiled_pattern, text)]
        self._train_chunks(chunks, vocab_size - 256,
                           {i: bytes([i]) for i in range(256)}, 256, verbose)

    def encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in re.findall(self.compiled_pattern, text):
            ids.extend(self._merge(list(chunk.encode("utf-8"))))
        return ids

    def load(self, model_file) -> None:
        super().load(model_file)
        self.compiled_pattern = re.compile(self.pattern)


class CodebookTokenizer(Tokenizer):
    """BPE over integer codec codes rendered as ``" %04d"`` strings.

    Matches the reference (mars5/minbpe/codebook.py): base vocabulary is the
    ``codebook_size`` raw code ids (rendered ``f" {i:04d}"``); merges mint ids from
    ``codebook_size`` upward; input "text" is a space-joined decimal string; there is
    no regex chunking (the code stream is one chunk). Special-token chunks in
    ``encode`` are stripped and empty chunks dropped (codebook.py:162-171).
    """

    def __init__(self, pattern: str | None = None, codebook_size: int = 1024):
        self.codebook_size = codebook_size
        super().__init__()
        self.pattern = pattern
        self.compiled_pattern = re.compile(self.pattern) if pattern is not None else None

    def _base_vocab_size(self) -> int:
        return self.codebook_size

    def _base_vocab(self) -> dict[int, bytes]:
        return {i: f" {i:04d}".encode("utf-8") for i in range(self.codebook_size)}

    def train(self, text: str, vocab_size: int, verbose: bool = False) -> None:
        assert vocab_size >= self.codebook_size
        chunks = [[int(t) for t in text.split(" ")]]
        self._train_chunks(chunks, vocab_size - self.codebook_size,
                           self._base_vocab(), self.codebook_size, verbose)

    def encode_ordinary(self, text: str) -> list[int]:
        return self._merge([int(t) for t in text.split(" ")])

    def decode_int(self, ids) -> list:
        """Decode BPE ids back to raw integer codes (specials kept as strings).

        Mirrors reference codebook.py:88-94: decode to the `" %04d"` string form,
        split on spaces, parse numerics.
        """
        ret = self.decode(ids)
        for s in self.special_tokens:
            ret = ret.replace(s, " " + s + " ")
        ret = ret.strip()
        return [int(t) if t[0].isnumeric() else t for t in ret.split(" ") if len(t) > 0]

    def _preprocess_special_chunk(self, part: str):
        part = part.strip()
        return None if len(part) == 0 else part

    def load(self, model_file) -> None:
        super().load(model_file)
        self.compiled_pattern = re.compile(self.pattern) if self.pattern else None
