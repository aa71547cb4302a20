"""Command-line synthesis on the card:
``python -m mars5_tts_torch.cli --text ... --ref ref.wav --ar AR --nar NAR``
(counterpart of ``mars5_tts_tpu/cli.py``, with the same flags, defaults and
modes).

Four modes: plain ``tts`` (the default), ``--longform`` (chunked text,
crossfaded), ``--stream`` (long form written to ``--out`` as each chunk
finalizes, with the time to the first audio) and ``--progressive`` (one
chunk of audio a denoised NAR segment, ``serving.stream_tts``). The model is
``Mars5TTS.from_local`` with the package's default backends. ``--device``
takes the place of the JAX ``--platform``: the card unless ``--device cpu``
is given, and an error, never a CPU run, when PyTorch sees no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import wave


def _positive_int(value: str) -> int:
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {value}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mars5-tts-torch",
                                description="Zero-shot voice-cloning TTS (PyTorch / CUDA)")
    p.add_argument("--text", required=True, help="text to synthesize")
    p.add_argument("--ref", required=True, help="reference WAV (ideally 24 kHz, 2-12 s)")
    p.add_argument("--transcript", default=None,
                   help="transcript of the reference audio (required for deep clone)")
    p.add_argument("--out", default="output.wav", help="output WAV path")
    p.add_argument("--ar", required=True, help="AR checkpoint (.safetensors/.pt)")
    p.add_argument("--nar", required=True, help="NAR checkpoint (.safetensors/.pt)")
    p.add_argument("--encodec", default=None,
                   help="Encodec encoder params (.npz pytree or official torch ckpt)")
    p.add_argument("--vocos", default=None,
                   help="Vocos vocoder params (.npz pytree or official torch ckpt)")
    p.add_argument("--shallow", action="store_true", help="shallow clone (no transcript)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--longform", action="store_true",
                      help="chunk long text and crossfade-stitch the result")
    mode.add_argument("--stream", action="store_true",
                      help="longform streaming: write PCM to --out incrementally as "
                           "each chunk finalizes and report time-to-first-audio")
    mode.add_argument("--progressive", action="store_true",
                      help="intra-utterance streaming: emit audio per denoised "
                           "NAR segment instead of once at the end; no silence trim")
    p.add_argument("--seg-frames", type=_positive_int, default=192,
                   help="progressive only: codec frames per emitted segment")
    p.add_argument("--ctx-frames", type=int, default=192,
                   help="progressive only: emitted-tail context frames per segment")
    p.add_argument("--trim-db", type=float, default=None,
                   help="silence-trim threshold in dB (InferenceConfig.trim_db)")
    p.add_argument("--max-chars", type=_positive_int, default=300,
                   help="longform/stream text chunk size in characters")
    p.add_argument("--first-chunk-chars", type=_positive_int, default=None,
                   help="stream only: smaller chunk budget for the FIRST chunk "
                        "(time-to-first-audio ramp, e.g. 80)")
    p.add_argument("--first-chunk-timesteps", type=_positive_int, default=None,
                   help="stream only: reduced NAR diffusion steps for the FIRST "
                        "chunk (later chunks use --timesteps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=200)
    p.add_argument("--top-p", type=float, default=0.2)
    p.add_argument("--timesteps", type=int, default=200)
    p.add_argument("--max-len", type=int, default=-1,
                   help="cap on total AR tokens (generate_max_len_override)")
    p.add_argument("--timings", action="store_true", help="print per-stage timings JSON")
    p.add_argument("--device", default=None,
                   help="torch device (e.g. cuda, cuda:1, cpu); default the card, and "
                        "an error when there is none")
    return p


def _write_stream(path, sr: int, chunks, label, progressive: bool):
    """Write each chunk's PCM to ``path`` as it comes, printing a line a
    chunk (``label(chunk, i)`` and the seconds written) and the time to the
    first audio: at the first chunk that holds samples when
    ``progressive``, else at the first text chunk. Returns (samples
    written, the chunks' timings, the time to the first audio in seconds)."""
    from .audio.io import float_to_pcm16

    t0 = time.perf_counter()
    total, timings, ttfa = 0, [], None
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        for i, chunk in enumerate(chunks):
            pcm = float_to_pcm16(chunk.pcm)
            w.writeframes(pcm.tobytes())
            now = time.perf_counter() - t0
            # a small progressive segment may hold all its samples back
            first = len(pcm) > 0 if progressive else chunk.index == 0
            if first and ttfa is None:
                ttfa = now
                print(f"time-to-first-audio {now:.2f}s ({len(pcm) / sr:.2f}s playable)")
                timings.append(dict(chunk.timing, ttfa_s=now))
            else:
                timings.append(chunk.timing)
            total += len(pcm)
            print(f"{label(chunk, i)} +{len(pcm) / sr:.2f}s "
                  f"(stream {total / sr:.2f}s at t={now:.2f}s)"
                  + (" [final]" if not progressive and chunk.final else ""))
    return total, timings, ttfa


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .audio.io import read_wav, write_wav
    from .config import InferenceConfig
    from .hub import load_codec_params
    from .pipeline import Mars5TTS, resolve_device

    device = resolve_device(args.device)
    ref_audio, _ = read_wav(args.ref, target_sr=24000)
    kwargs = {}
    if args.encodec:
        kwargs["encodec_params"] = load_codec_params(args.encodec, "encodec")
    if args.vocos:
        kwargs["vocos_params"] = load_codec_params(args.vocos, "vocos")
    model = Mars5TTS.from_local(args.ar, args.nar, device=device, **kwargs)
    cfg_kwargs = {}
    if args.trim_db is not None:
        cfg_kwargs["trim_db"] = args.trim_db
    cfg = InferenceConfig(deep_clone=not args.shallow, temperature=args.temperature,
                          top_k=args.top_k, top_p=args.top_p,
                          timesteps=args.timesteps,
                          generate_max_len_override=args.max_len, **cfg_kwargs)
    transcript = args.transcript if args.transcript is not None else ("" if args.shallow else None)

    if args.progressive or args.stream:
        from .serving import stream_longform, stream_tts

        if args.progressive:
            chunks = stream_tts(model, args.text, ref_audio, ref_transcript=transcript,
                                cfg=cfg, seed=args.seed, seg_frames=args.seg_frames,
                                ctx_frames=max(0, args.ctx_frames))
            label = lambda c, i: f"segment {i}: frames [{c.frame_start},{c.frame_end})"
        else:
            chunks = stream_longform(model, args.text, ref_audio, ref_transcript=transcript,
                                     cfg=cfg, max_chars=args.max_chars, seed=args.seed,
                                     first_chunk_chars=args.first_chunk_chars,
                                     first_chunk_timesteps=args.first_chunk_timesteps)
            label = lambda c, i: f"chunk {c.index}:"
        total, timings, _ = _write_stream(args.out, model.sr, chunks, label, args.progressive)
        print(f"wrote {args.out} ({total / model.sr:.2f}s)")
        if args.timings:
            print(json.dumps(timings))
        return 0

    if args.longform:
        from .serving import synthesize_longform
        audio = synthesize_longform(model, args.text, ref_audio, ref_transcript=transcript,
                                    cfg=cfg, max_chars=args.max_chars, seed=args.seed).audio
    else:
        _, audio = model.tts(args.text, ref_audio, ref_transcript=transcript,
                             cfg=cfg, seed=args.seed)

    write_wav(args.out, audio, sr=model.sr)
    print(f"wrote {args.out} ({len(audio) / model.sr:.2f}s)")
    if args.timings:
        print(json.dumps(model.last_timing))
    return 0


if __name__ == "__main__":
    sys.exit(main())
