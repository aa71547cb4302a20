"""ctypes loader for the native C++ BPE merge engine (native/bpe.cc).

Compiles the shared object on first use (g++, cached next to the source) and
exposes ``merge_ids_native``; ``available()`` gates the fast path so the pure
Python implementation remains the portable fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "bpe.cc"
_SO = _SRC.with_suffix(".so")


def _build() -> Path | None:
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(_SO)],
            check=True, capture_output=True, timeout=120)
        return _SO
    except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
        logging.debug("native BPE build failed: %s", e)
        return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _SRC.exists():
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:  # pragma: no cover
        return None
    lib.bpe_merge.restype = ctypes.c_int32
    lib.bpe_merge.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return os.environ.get("MARS5_NO_NATIVE_BPE") != "1" and _load() is not None


class MergeTable:
    """Pre-marshalled merge table (build once per tokenizer)."""

    def __init__(self, merges: dict):
        n = len(merges)
        self.a = np.fromiter((p[0] for p in merges), np.int32, n)
        self.b = np.fromiter((p[1] for p in merges), np.int32, n)
        self.idx = np.fromiter(merges.values(), np.int32, n)
        self._pa = self.a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._pb = self.b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._pi = self.idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self.n = n


def merge_ids_native(ids, table: MergeTable) -> list[int]:
    lib = _load()
    arr = np.asarray(ids, np.int32)
    out = np.empty_like(arr)
    m = lib.bpe_merge(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
        table._pa, table._pb, table._pi, table.n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if m < 0:  # pragma: no cover
        raise RuntimeError("native bpe_merge failed")
    return out[:m].tolist()
