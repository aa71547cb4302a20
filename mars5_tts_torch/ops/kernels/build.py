"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is compiled from ``mars5_tts_torch/csrc`` for ``sm_90a`` into
``build/kernels/`` at the repository root, named by a hash of its sources and
flags, so an edited source never loads a stale binary. Nothing is compiled
when a module is imported: the first launch builds, or ``build_all`` builds
every library at once, one nvcc each, in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Every library: its sources under csrc/ (headers count in the hash only).
LIBRARIES = {
    "mha": ("mha.cu", "hopper.cuh", "warp_mma.cuh"),
    "nar_fused": ("nar_fused.cu", "w8a8_wgmma.cuh", "hopper.cuh", "warp_mma.cuh"),
    "nar_mega": ("nar_mega.cu", "w8a8_wgmma.cuh", "hopper.cuh", "warp_mma.cuh"),
    "diffusion_tail": ("diffusion_tail.cu", "hopper.cuh", "warp_mma.cuh"),
    "decode_layer": ("decode_layer.cu", "gemv_s8.cuh", "hopper.cuh", "warp_mma.cuh"),
    "head4": ("head4.cu", "gemv_s8.cuh", "warp_mma.cuh"),
    "decode_attention": ("decode_attention.cu", "warp_mma.cuh"),
    "moe_decode": ("moe_decode.cu", "warp_mma.cuh"),
}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``sources`` (relative to csrc/) into one shared library;
    headers (``.cuh``) among them count in the library's hash only. nvcc's
    output (the ptxas register and spill lines) goes to ``build_log[name]``
    and beside the library as ``.log``, from where a library built before is
    read back (no entry when that file is missing)."""
    out = library_path(name, sources)
    log = out.with_suffix(".log")
    if out.exists():
        if name not in build_log and log.exists():
            build_log[name] = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{build_log[name]}")
    tmp_log = log.with_suffix(f".{os.getpid()}.logtmp")
    tmp_log.write_text(build_log[name])
    os.replace(tmp_log, log)  # before the library: a library found has its log
    os.replace(tmp, out)  # atomic: a concurrent process never sees a partial file
    return out


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """The loaded library, building it on first use in this process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name, sources)))
    return _loaded[name]


def call(device, fn, *args) -> None:
    """Calls the C entry ``fn`` with ``args`` and the current stream of
    ``device`` appended, with ``device`` the current device (switched only
    when it is not); raises on a nonzero cudaError. The stream is read as
    the raw handle PyTorch's own kernel launchers take
    (``torch.cuda.current_stream()`` builds a Stream object at each call)."""
    import torch

    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    if idx == cur:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")


def build_all() -> dict[str, Path]:
    """Compile every library of ``LIBRARIES``, one nvcc each, all at once."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(lambda kv: build(*kv), LIBRARIES.items())))
