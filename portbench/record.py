"""What the window's requests produced, kept for the comparison after it.

The recorder wraps, for the length of the window, the calls through which the
timed path hands on its results, on whichever route the configuration takes:
every AR engine the pipeline calls (``ar_generate*``: the served token ids)
and the uniform stream each draws its tokens from, the Encodec encode (the
reference's codes), the NAR engine (its conditioning), two calls inside each
reverse step, the decoder (its input x_t and its row count) and the tail
(the step's uniforms and its draw), and Vocos (the audio before the trim).

Of every call it keeps the served tokens, the shape of the codes and the
row count of each reverse step. Of the calls the comparison reads
(``keep``: chosen before the window, ``check.chosen``) it also keeps the
codes, the AR's uniforms, three reverse steps (one with CFG, one without,
and t = 0), the code grid and the audio, each copied as it is made into a
host arena of pinned memory reserved in set-up (``Pinned``: a copy queued
behind the step, which the host does not wait for), so that the device
holds nothing of the benchmark's, ``torch.cuda.max_memory_allocated`` reads
the program alone, and no pinned allocation stalls the window.

``Marks`` (traced runs only) puts profiler ranges around kernels K4 and K9
and counts the work of every K2, K4 and K9 call from its arguments' shapes
(``portbench/work.py``), for the roofline readers.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from . import work


def _patch(owner, name, make):
    """Wraps ``owner.name`` with ``make``; returns what ``_unpatch`` needs (the
    old value, or None where it was a method found on the class)."""
    own = name in vars(owner)
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    return owner, name, old if own else None


def _unpatch(undo):
    for owner, name, old in reversed(undo):
        if old is None:
            delattr(owner, name)
        else:
            setattr(owner, name, old)
    undo.clear()


class Pinned:
    """A host arena of ``nbytes`` (pinned where ``device`` is a card) that
    the recorder's copies land in, each queued on its stream and valid once
    the device has synchronised. A copy that does not fit gets a host
    tensor of its own."""

    ALIGN = 64

    def __init__(self, nbytes: int, device):
        self.buf = torch.empty(int(nbytes), dtype=torch.uint8,
                               pin_memory=torch.device(device).type == "cuda")
        self.off = 0

    def copy(self, t):
        t = t.detach()
        n = t.numel() * t.element_size()
        start = -(-self.off // self.ALIGN) * self.ALIGN
        if start + n > self.buf.numel():
            return t.to("cpu", non_blocking=True)
        self.off = start + n
        out = self.buf[start:start + n].view(t.dtype).view(t.shape)
        out.copy_(t, non_blocking=True)
        return out


def arena_bytes(cycle, keep, n_quant: int, hop: int) -> int:
    """An upper bound of what the recorder copies of the calls ``keep`` of
    ``cycle``: three reverse steps over at most twice the references plus
    the output (the uniforms (rows, L, 7, K) float32, x_t and the draw
    (rows, L, 7), x (rows, L, 8), its mask), the AR's uniforms, the codes,
    the grid and the audio."""
    total = 0
    for i in keep:
        req = cycle[i % len(cycle)]
        rows, ref = len(req.texts), max(req.ref_frames)
        frames = 2 * ref + req.out_frames + 128
        step = rows * frames * (7 * n_quant * 4 + 2 * 7 * 8 + 8 * 8 + 1)
        prompt = max(len(t) + len(tr) for t, tr in zip(req.texts, req.transcripts)) + 8 + ref
        total += (3 * step + (prompt + req.out_frames + 8) * rows * 4
                  + rows * ref * 8 * 8 + rows * frames * (8 * 8 + hop * 4))
    return total + 2**20


def steps_to_keep(T: int, interval, rng) -> set:
    """The reverse steps' t to keep: 0, one drawn with CFG and one drawn
    without it where the guidance interval leaves any."""
    lo, hi = int(round(interval[0] * T)), int(round(interval[1] * T))
    cfg_ts = [t for t in range(1, T) if lo <= t < hi]
    plain = [t for t in range(1, T) if not lo <= t < hi]
    keep = {0}
    for pool in (cfg_ts, plain):
        if pool:
            keep.add(int(rng.choice(pool)))
    return keep


def _modules_with(value):
    """(module, name) of every loaded module of the program holding ``value``
    under some name."""
    out = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith("mars5_tts_torch"):
            continue
        for name, v in list(vars(mod).items()):
            if v is value:
                out.append((mod, name))
    return out


class Recorder:
    def __init__(self, tts, seed: int, interval, keep: set, arena: Pinned):
        self.tts = tts
        self.arena = arena
        self.interval = tuple(interval)
        self.keep = set(keep)
        self.requests: list = []
        self.cur = None
        self._undo = []
        self._stash = None
        self._rng = np.random.default_rng([int(seed) % 2**128, 7])

    # ---------------------------------------------------------------- wrappers
    def install(self):
        from mars5_tts_torch import pipeline
        from mars5_tts_torch.diffusion import engine
        from mars5_tts_torch.models import ar_decode

        rec = self
        host = self.arena.copy

        def keep_ar(fn):
            @functools.wraps(fn)
            def run(*a, **kw):
                out = fn(*a, **kw)
                rows = out if isinstance(out, list) else [out]
                rec.cur["ar"] = [(np.asarray(s).copy(), int(n)) for s, n in rows]
                return out
            return run

        for name in sorted(vars(pipeline)):
            if name.startswith("ar_generate") and callable(getattr(pipeline, name)):
                self._undo.append(_patch(pipeline, name, keep_ar))

        def keep_u(fn):
            @functools.wraps(fn)
            def run(*a, **kw):
                u = fn(*a, **kw)
                if rec.cur is not None and rec.cur["kept"]:
                    rec.cur["u"] = host(u)
                return u
            return run

        for mod, name in _modules_with(ar_decode.uniform_stream):
            self._undo.append(_patch(mod, name, keep_u))

        def keep_codes(fn):
            @functools.wraps(fn)
            def run(audio):
                out = fn(audio)
                keep = rec.cur["kept"]
                rec.cur["codes"].append(host(out) if keep else
                                        torch.empty(out.shape, dtype=out.dtype, device="meta"))
                return out
            return run

        self._undo.append(_patch(self.tts, "encode_reference", keep_codes))

        def keep_nar(fn):
            @functools.wraps(fn)
            def run(model, batch, diff, T, *a, **kw):
                ts = steps_to_keep(T, rec.interval, rec._rng) if rec.cur["kept"] else set()
                rec.cur["nar"] = {"batch": batch, "T": T, "keep": ts, "rows": [],
                                  "steps": [], "calls": 0}
                return fn(model, batch, diff, T, *a, **kw)
            return run

        self._undo.append(_patch(pipeline, "perform_simple_inference", keep_nar))

        def keep_x(fn):
            @functools.wraps(fn)
            def run(x, x_padding_mask, *a, q_tail_start=0, **kw):
                nar = rec.cur["nar"]
                nar["rows"].append(int(x.shape[0]))
                if nar["T"] - 1 - nar["calls"] in nar["keep"]:
                    rec._stash = (x, x_padding_mask, q_tail_start)
                return fn(x, x_padding_mask, *a, q_tail_start=q_tail_start, **kw)
            return run

        self._undo.append(_patch(self.tts.codecnar, "decoder_apply", keep_x))

        def keep_step(fn, iu, ix):
            """The tail ``fn`` takes the step's uniforms and x_t as its
            arguments ``iu`` and ``ix``."""
            @functools.wraps(fn)
            def run(*a, **kw):
                out = fn(*a, **kw)
                nar = rec.cur["nar"]
                t = nar["T"] - 1 - nar["calls"]
                nar["calls"] += 1
                if t in nar["keep"] and rec._stash is not None:
                    x, xpm, offset = rec._stash
                    u0, x_t = a[iu], a[ix]
                    bs = u0.shape[0]
                    nar["steps"].append({"t": t, "x": host(x[:bs]), "xpm": host(xpm[:bs]),
                                         "offset": offset, "u0": host(u0), "x_t": host(x_t),
                                         "out": host(out)})
                rec._stash = None
                return out
            return run

        for name, iu, ix in (("heads_diffusion_tail", 3, 4), ("diffusion_tail", 1, 2)):
            self._undo.append(_patch(engine, name,
                                     lambda fn, iu=iu, ix=ix: keep_step(fn, iu, ix)))

        def keep_audio(fn):
            @functools.wraps(fn)
            def run(*a, **kw):
                out = fn(*a, **kw)
                if rec.cur["kept"]:
                    rec.cur["audio"] = host(out)
                return out
            return run

        if self.tts.vocos is not None:
            self._undo.append(_patch(self.tts.vocos, "decode", keep_audio))

    def uninstall(self):
        _unpatch(self._undo)

    # ---------------------------------------------------------------- requests
    def begin(self, request, index: int, kept: bool | None = None):
        """Call ``index`` of the window (from 0) starts; ``kept`` overrides
        whether its outputs are kept (the warm-up's are, so that the window
        runs no copy for the first time)."""
        kept = index in self.keep if kept is None else kept
        self.cur = {"request": request, "index": index, "kept": kept,
                    "ar": None, "u": None, "codes": [], "nar": None, "audio": None,
                    "grid": None}

    def finish(self, frames: list, stages: dict, wall_s: float):
        """The call completed, with ``frames`` of audio a row."""
        c = self.cur
        c.update(frames=frames, stages=stages, wall_s=wall_s)
        if c["kept"] and self.tts.last_grid is not None:
            c["grid"] = self.arena.copy(torch.as_tensor(self.tts.last_grid))
        self.requests.append(c)
        self.cur = None

    def reset(self):
        """Forgets the calls so far (the warm-up) and empties the arena."""
        self.requests.clear()
        self.arena.off = 0


class Marks:
    """Profiler ranges around K4 and K9, and the bound of every K2, K4 and K9
    call (``work.bound`` of the call's work) summed, for the roofline readers
    (traced runs)."""

    K4, K9 = "portbench.K4", "portbench.K9"

    def __init__(self):
        self._undo = []
        self.reset()

    def reset(self):
        self.k2_bound_s = 0.0
        self.k4_bound_s = 0.0
        self.k9 = []                # (dims, x shape, memory length, masks)

    def install(self):
        from torch.profiler import record_function

        from mars5_tts_torch.models import ar_decode_fused, layers

        marks = self

        def k2(fn):
            @functools.wraps(fn)
            def run(fp, x, pos, *a, dims, **kw):
                nb, ops = work.k2_step(dims.n_layers, dims.dim, dims.hidden, dims.wbits,
                                       dims.window, [int(p) for p in np.atleast_1d(pos)])
                marks.k2_bound_s += work.bound(nb, int8=ops)[0]
                return fn(fp, x, pos, *a, dims=dims, **kw)
            return run

        def k4(fn):
            @functools.wraps(fn)
            def run(x, ln, w, v, l2, *a, **kw):
                d, f = x.shape[-1], w[0].shape[0]
                nb, ops = work.k4_call(x.numel() // d, d, f)
                marks.k4_bound_s += work.bound(nb, int8=ops)[0]
                with record_function(marks.K4):
                    return fn(x, ln, w, v, l2, *a, **kw)
            return run

        def k9(fn):
            @functools.wraps(fn)
            def run(mp, x, mem, tm=None, mm=None, *a, **kw):
                marks.k9.append((mp.dims, tuple(x.shape), mem.shape[1], tm, mm))
                with record_function(marks.K9):
                    return fn(mp, x, mem, tm, mm, *a, **kw)
            return run

        self._undo = [_patch(ar_decode_fused, "fused_decode_layers", k2),
                      _patch(layers, "fused_ffn", k4), _patch(layers, "mega_decoder_stack", k9)]

    def uninstall(self):
        _unpatch(self._undo)

    def k9_bound_s(self) -> float:
        """The summed bound of the K9 calls (the masks' valid keys counted
        now, after the window)."""
        tot = 0.0
        for d, (b, l, dim), lk, tm, mm in self.k9:
            vs = int((~tm).sum()) if tm is not None else b * l
            vm = int((~mm).sum()) if mm is not None else b * lk
            nb, i8, bf = work.k9_call(d.n_layers, b, l, lk, dim, d.hidden, d.nhead, vs, vm)
            tot += work.bound(nb, int8=i8, bf16=bf)[0]
        return tot
