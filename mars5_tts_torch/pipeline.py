"""Mars5TTS, the public synthesis API
(counterpart of ``mars5_tts_tpu/pipeline.py``).

tokenize -> Encodec-encode the reference -> speech-BPE its L0 codes -> deep or
shallow prompt -> AR decode -> parse -> NAR diffusion -> Vocos -> silence
trim, step for step as the JAX package (and the reference) does it.
``tts_batch`` runs several texts at once, with one shared voice or one voice
a text: one Encodec encode per distinct reference, one batched AR decode
(per-row prompts, speaker codes, cursors and EOS estimates), one NAR
diffusion over the padded rows (rows with different reference lengths take
the engine's ragged branch), batched Vocos.

AR backends: ``"bf16"`` (the model as loaded), ``"fused"`` (W8A8) or
``"fused4"`` (W4A8, nibble-packed), the quantized engine of
``models/ar_decode_fused.py`` through kernel K2, with ``head4=True`` (fused4
only) reading the output head as int4 through kernel K8. The quantized pack
is built at the first request and kept. NAR backends: ``"bf16"`` (the model
as loaded) or ``"int8"`` (W8A8 with per-row scales,
``ops/quant.quantize_nar``, served through kernels K1, K3, K4 and K6). The
int8 NAR takes two more routes: ``nar_mega=True`` runs its decoder stack
through kernel K9 (the JAX ``MARS5_NAR_MEGA=1``; its operand pack is built
at the first request and kept), and ``nar_tail`` picks the
tail of each reverse step: ``"heads"`` (K6, the default), ``"split"`` (the
folded heads, then K5; JAX ``MARS5_FUSED_HEADTAIL=0``) or ``"dense"`` (the
folded heads and the PyTorch tail; JAX ``MARS5_FUSED_TAIL=0``).

The NAR's routes (``models.layers.NarOptions``), one to one with the JAX
package's environment knobs: ``nar_fused`` (``MARS5_NAR_FUSED``: the fused
W8A8 decoder layer; False runs its unfused products), ``nar_sites``
(``MARS5_NARF_SITES``: which GEMM sites of the fused layer run in K3/K4),
``nar_gsize`` (``MARS5_NARF_GSIZE``: per-K-group scales of that many
columns, the weights quantized to match, ``quantize_nar(w_gsize=)``),
``nar_qattn`` (``MARS5_QATTN``: K1's int8 mode for the unfused layers'
attention), ``nar_cross_k1`` (``MARS5_CROSS_PALLAS``: long-query
cross-attention through K1, the bf16 NAR's too) and ``nar_sdpa_bf16``
(``MARS5_SDPA_BF16``: a bf16 NAR's plain attention rounds its scores to
bf16; False keeps them f32). ``int4_mse`` (``MARS5_INT4_MSE``): the fused4
pack's int4 scales from the clip search (False: amax scales). The AR may
come quantized by ``ops/quant.quantize_codeclm`` (int8 weights under the bf16
engine, the JAX ``BENCH_AR=int8``); the fused backends then refuse it.

Serving options, as in the JAX package: ``guidance_interval=(lo, hi)`` keeps
CFG to the reverse steps with t in ``[round(lo T), round(hi T))`` (the
others run the conditional rows alone); ``nar_gen_bucket`` /
``nar_text_bucket`` pad the NAR's generated-frame and text axes up to
multiples of the bucket (default ``MARS5_NAR_GEN_BUCKET`` /
``MARS5_NAR_TEXT_BUCKET``, else 0: exact shapes). ``InferenceConfig(
use_kv_cache=False)`` decodes the AR without a cache
(``ar_generate_nocache``, on the model as loaded, whatever ``ar_backend``);
``tts_batch`` then takes the bf16 batched engine. ``from_pretrained`` finds
the checkpoints through ``huggingface_hub`` or in a local cache.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .audio.trim import trim
from .config import DSH, InferenceConfig
from .diffusion.engine import TAILS, perform_simple_inference
from .diffusion.multinomial import MultinomialDiffusion
from .hub import load_checkpoint, load_tokenizers
from .models.ar import CodecLM, CodecLMConfig
from .models.ar_decode import (ArSampling, ar_generate, ar_generate_batched,
                               ar_generate_nocache, ar_vocab_window, expert_load,
                               expert_load_summary)
from .models.ar_decode_fused import FusedEngine, prepare_fused
from .models.convert import (infer_codeclm_config, infer_nar_config, load_codeclm,
                             load_nar)
from .models.encodec import EncodecConfig, EncodecEncoder, encodec_from_pytree
from .models.layers import DEFAULT_OPTIONS, NarOptions
from .models.nar import ResidualTransformer, ResidualTransformerConfig
from .models.vocos import Vocos, VocosConfig, codes_to_features, vocos_from_pytree
from .ops.kernels.decode_layer import make_dims
from .ops.kernels.nar_mega import build_mega_pack, mega_supported
from .ops.quant import nar_w_group_keys, quantize_nar
from .utils.profiling import StageTimer, span


def default_device() -> torch.device:
    """The card. Raises when PyTorch sees none: the entry points never land
    on the CPU unasked (pass ``device="cpu"`` for that)."""
    if not torch.cuda.is_available():
        raise RuntimeError("Mars5TTS: PyTorch sees no CUDA device; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``default_device()``, and a
    CUDA device raises as it does when PyTorch sees no card."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device


class Mars5TTS:
    """AR codec LM + NAR diffusion refiner + Encodec encoder + Vocos vocoder,
    all on one ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, ar_ckpt: dict, nar_ckpt: dict, *, encodec_params=None,
                 vocos_params=None, ar_cfg: Optional[CodecLMConfig] = None,
                 nar_cfg: Optional[ResidualTransformerConfig] = None,
                 encodec_cfg: Optional[EncodecConfig] = None,
                 vocos_cfg: Optional[VocosConfig] = None,
                 device=None, dtype=torch.float32, ar_backend: str = "bf16",
                 nar_backend: str = "bf16", head4: bool = False, nar_mega: bool = False,
                 nar_tail: str = "heads", nar_fused: bool = True,
                 nar_sites: tuple = DEFAULT_OPTIONS.sites, nar_gsize: int = 0,
                 nar_qattn: bool = False, nar_cross_k1: bool = False,
                 nar_sdpa_bf16: bool = True, int4_mse: bool = True,
                 guidance_interval: tuple = (0.0, 1.0), nar_gen_bucket: Optional[int] = None,
                 nar_text_bucket: Optional[int] = None):
        """From reference-layout checkpoints ({'vocab', 'model'[, 'config']}),
        with Encodec/Vocos given as the JAX package's parameter pytrees.
        ``device`` defaults to ``default_device()``. ``nar_backend="int8"``
        quantizes the NAR after loading, unless its checkpoint is already
        quantized; ``ar_backend``, ``head4``, ``nar_mega``, ``nar_tail``, the
        ``nar_*`` routes, ``guidance_interval`` and the buckets as in the
        module docstring. Encodec and Vocos stay f32 whatever ``dtype``
        the AR and NAR take."""
        device = resolve_device(device)
        texttok, speechtok = load_tokenizers(ar_ckpt)
        n_vocab = len(texttok.vocab) + len(speechtok.vocab)
        if ar_cfg is None:
            ar_cfg = (CodecLMConfig(**ar_ckpt["config"]) if "config" in ar_ckpt
                      else infer_codeclm_config(ar_ckpt["model"], n_vocab=n_vocab))
        if nar_cfg is None:
            nar_cfg = (ResidualTransformerConfig(**nar_ckpt["config"]) if "config" in nar_ckpt
                       else infer_nar_config(nar_ckpt["model"]))
        codeclm = load_codeclm(ar_ckpt["model"], ar_cfg, dtype, device)
        codecnar = load_nar(nar_ckpt["model"], nar_cfg, dtype, device)
        encodec = (encodec_from_pytree(encodec_params, encodec_cfg)
                   if encodec_params is not None else None)
        vocos = vocos_from_pytree(vocos_params, vocos_cfg) if vocos_params is not None else None
        self._setup(codeclm, codecnar, texttok, speechtok, encodec, vocos, device,
                    ar_backend, nar_backend, head4, nar_mega, nar_tail,
                    NarOptions(nar_fused, nar_sites, nar_gsize, nar_qattn, nar_cross_k1,
                               nar_sdpa_bf16),
                    int4_mse, guidance_interval, nar_gen_bucket, nar_text_bucket)

    @classmethod
    def from_local(cls, ar_path, nar_path, **kwargs) -> "Mars5TTS":
        """From local .safetensors/.pt checkpoints in the reference layout;
        ``kwargs`` as ``__init__`` (``device`` defaults to the card)."""
        return cls(load_checkpoint(ar_path), load_checkpoint(nar_path), **kwargs)

    @classmethod
    def from_params(cls, codeclm: CodecLM, codecnar: ResidualTransformer, *,
                    texttok, speechtok, encodec: Optional[EncodecEncoder] = None,
                    vocos: Optional[Vocos] = None, device=None,
                    ar_backend: str = "bf16", nar_backend: str = "bf16",
                    head4: bool = False, nar_mega: bool = False,
                    nar_tail: str = "heads", nar_fused: bool = True,
                    nar_sites: tuple = DEFAULT_OPTIONS.sites, nar_gsize: int = 0,
                    nar_qattn: bool = False, nar_cross_k1: bool = False,
                    nar_sdpa_bf16: bool = True, int4_mse: bool = True,
                    guidance_interval: tuple = (0.0, 1.0),
                    nar_gen_bucket: Optional[int] = None,
                    nar_text_bucket: Optional[int] = None) -> "Mars5TTS":
        """From already-built port modules and tokenizer objects. With
        ``nar_backend="int8"`` a bf16/f32 ``codecnar`` is quantized into a new
        module (the given one is left as it was); a quantized one is used as
        it is when its scales are those ``nar_gsize`` and ``nar_sites`` ask
        for, else ValueError. The quantized AR backends leave ``codeclm`` as
        it is. The device defaults to that of ``codeclm``'s weights."""
        self = cls.__new__(cls)
        device = device or codeclm.embed.weight.device
        self._setup(codeclm, codecnar, texttok, speechtok, encodec, vocos, device,
                    ar_backend, nar_backend, head4, nar_mega, nar_tail,
                    NarOptions(nar_fused, nar_sites, nar_gsize, nar_qattn, nar_cross_k1,
                               nar_sdpa_bf16),
                    int4_mse, guidance_interval, nar_gen_bucket, nar_text_bucket)
        return self

    def _setup(self, codeclm, codecnar, texttok, speechtok, encodec, vocos, device,
               ar_backend, nar_backend, head4, nar_mega, nar_tail, opts, int4_mse,
               guidance_interval, nar_gen_bucket, nar_text_bucket):
        if ar_backend not in ("bf16", "fused", "fused4"):
            raise ValueError(f"unknown ar_backend {ar_backend!r}")
        if head4 and ar_backend != "fused4":
            raise ValueError("head4=True needs ar_backend='fused4'")
        if not codeclm.cfg.is_mha and ar_backend != "bf16":
            raise ValueError(f"ar_backend={ar_backend!r} runs the MARS5 block only (K2, K8); "
                             "an AR with latent attention or experts runs on "
                             "ar_backend='bf16'")
        if codeclm.is_quantized and ar_backend != "bf16":
            raise ValueError("a quantize_codeclm AR runs on ar_backend='bf16'; the fused "
                             "backends pack the unquantized weights")
        self.ar_backend, self.head4, self.int4_mse = ar_backend, head4, int4_mse
        self._fused_cache: dict = {}
        self._mega_pack = None
        if nar_backend not in ("bf16", "int8"):
            raise ValueError(f"unknown nar_backend {nar_backend!r}")
        if opts.gsize and not opts.fused:
            raise ValueError("nar_gsize > 0 needs nar_fused=True: group scales run only in "
                             "the fused kernels")
        if nar_backend == "bf16" and (opts.qattn or not opts.fused or opts.gsize
                                      or opts.sites != DEFAULT_OPTIONS.sites):
            raise ValueError("nar_fused, nar_sites, nar_gsize and nar_qattn need "
                             "nar_backend='int8'")
        if nar_mega and (opts.gsize or opts.sites != DEFAULT_OPTIONS.sites):
            raise ValueError("nar_mega=True takes neither grouped scales (nar_gsize) nor "
                             "another site set (nar_sites): kernel K9 runs every site with "
                             "per-row scales")
        if nar_backend == "int8":
            codecnar = quantize_nar(codecnar, w_gsize=opts.gsize,
                                    w_group_keys=nar_w_group_keys(opts.sites))
        elif codecnar.is_quantized:
            raise ValueError("a quantized NAR needs nar_backend='int8'")
        if nar_tail not in TAILS:
            raise ValueError(f"unknown nar_tail {nar_tail!r}")
        if (nar_mega or nar_tail != "heads") and nar_backend != "int8":
            raise ValueError("nar_mega and nar_tail need nar_backend='int8'")
        if nar_mega and not mega_supported(codecnar.tfm.decoder):
            raise ValueError("nar_mega=True: the NAR decoder's geometry does not fit kernel "
                             "K9 (head dim 64, D and F multiples of 128 up to 3072)")
        self.nar_backend, self.nar_mega, self.nar_tail = nar_backend, nar_mega, nar_tail
        self.nar_options = opts
        self.guidance_interval = tuple(guidance_interval)
        self.nar_gen_bucket = int(os.environ.get("MARS5_NAR_GEN_BUCKET", "0")
                                  if nar_gen_bucket is None else nar_gen_bucket)
        self.nar_text_bucket = int(os.environ.get("MARS5_NAR_TEXT_BUCKET", "0")
                                   if nar_text_bucket is None else nar_text_bucket)
        self.device = torch.device(device)

        def ready(m):
            return None if m is None else m.to(self.device).requires_grad_(False).eval()

        self.codeclm, self.codecnar = ready(codeclm), ready(codecnar)
        self.encodec, self.vocos = ready(encodec), ready(vocos)
        self.ar_cfg, self.nar_cfg = codeclm.cfg, codecnar.cfg
        self.texttok, self.speechtok = texttok, speechtok
        self.n_vocab = len(texttok.vocab) + len(speechtok.vocab)
        self.n_text_vocab = len(texttok.vocab) + 1
        self.diffusion_n_classes = 1025
        self._valid_window = ar_vocab_window(len(texttok.vocab), len(speechtok.vocab),
                                             self.ar_cfg.n_vocab)
        self.default_T = 200
        self.sr = 24000
        self.last_timing: dict = {}
        self.last_grid = None
        self._last_ar_runaway = False

    def _ar_engine(self, max_len: int, rows: int = 1):
        """The AR decode engine of a call of ``rows`` rows up to ``max_len``:
        None (the model as loaded) on ``ar_backend="bf16"``, else the
        quantized engine with dims for the rows. Its pack is built at first
        use and kept per ``max_len``, the weights packed once and shared."""
        if self.ar_backend == "bf16":
            return None
        if max_len not in self._fused_cache:
            wbits = 4 if self.ar_backend == "fused4" else 8
            if self._fused_cache:
                fp, _ = next(iter(self._fused_cache.values()))
                dims = make_dims(self.ar_cfg, max_len, wbits)
            else:
                fp, dims = prepare_fused(self.codeclm, max_len, wbits, self.head4,
                                         int4_mse=self.int4_mse)
            self._fused_cache[max_len] = (fp, dims)
        fp, dims = self._fused_cache[max_len]
        return FusedEngine(fp, dataclasses.replace(dims, batch=rows))

    def _get_mega(self):
        """The K9 operand bundle of the int8 NAR decoder, built at the first
        ``nar_mega`` request and kept (None without ``nar_mega``)."""
        if self.nar_mega and self._mega_pack is None:
            self._mega_pack = build_mega_pack(self.codecnar.tfm.decoder)
        return self._mega_pack

    def _reset_expert_load(self):
        load = expert_load(self.codeclm)
        if load is not None:
            load.zero_()

    def _report_expert_load(self):
        """``last_timing["ar_expert_load"]``: each expert layer's largest and
        mean count of routed decode slots in the call (an AR with experts)."""
        summary = expert_load_summary(self.codeclm)
        if summary is not None:
            self.last_timing["ar_expert_load"] = summary

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ codecs
    def encode_reference(self, ref_audio) -> torch.Tensor:
        """(T,) or (ch, T) 24 kHz audio -> (1, n_q, frames) codes."""
        if self.encodec is None:
            raise RuntimeError("Encodec encoder parameters were not provided")
        audio = np.asarray(ref_audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        return self.encodec(torch.as_tensor(audio, device=self.device)[None])

    def vocode(self, tokens) -> np.ndarray:
        """(seq_len, n_q) token grid -> (T,) audio, bandwidth id 1."""
        if self.vocos is None:
            raise RuntimeError("Vocos vocoder parameters were not provided")
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return self.vocos.vocode(tokens, bandwidth_id=1).cpu().numpy()

    @torch.inference_mode()
    def get_speaker_embedding(self, ref_audio) -> np.ndarray:
        """Reference audio -> (1, dim) AR implicit speaker embedding."""
        codes = self.encode_reference(ref_audio).transpose(1, 2)
        return self.codeclm.spk_embedding(codes).float().cpu().numpy()

    # --------------------------------------------------------------- tts
    @torch.inference_mode()
    def tts(self, text: str, ref_audio, ref_transcript: Optional[str] = None,
            cfg: Optional[InferenceConfig] = None, seed: int = 0,
            max_retries: int = 0):
        """Synthesize ``text`` in the voice of ``ref_audio``; returns
        ``(ar_codes (Lgen,) int64 L0 ids, waveform (T,) float32 24 kHz)``.

        ``max_retries``: when the AR reaches its length cap without EOS, retry
        with a reseeded sampler up to this many times before accepting the
        truncated output. The AR draws from ``seed``, the diffusion from
        ``seed + 1``.

        ``last_timing`` then holds each stage's wall seconds (``stages_s``),
        their sum (``total_s``), ``audio_s``, the trimmed audio's seconds,
        ``rtf``, the total over ``audio_s``, and ``grid_audio_s``, the seconds
        of the served grid before the trim: its frames x the vocoder's hop /
        24,000; an AR with experts adds ``ar_expert_load`` (each expert
        layer's largest and mean count of routed decode slots).
        """
        if max_retries:
            for attempt in range(max_retries + 1):
                result = self.tts(text, ref_audio, ref_transcript, cfg,
                                  seed=seed + 1000 * attempt)
                if not self._last_ar_runaway or attempt == max_retries:
                    return result
                logging.warning("runaway AR decode; retrying (%d/%d)", attempt + 1,
                                max_retries)
        with span("request"):
            cfg = cfg or InferenceConfig()
            timer = StageTimer(sync=self._sync)
            text_tokens, prompt_codec, raw_prompt_len, gen_codes = self._synthesize_codes(
                text, ref_audio, ref_transcript, cfg, seed, timer)

            with timer.stage("nar_diffusion"):
                c_codes = prompt_codec.transpose(1, 2)
                x = np.repeat(gen_codes[None, :, None], 8, axis=2)
                grid = self._nar((np.asarray(text_tokens, np.int64)[None], c_codes,
                                  np.asarray([len(text_tokens)]), np.asarray([c_codes.shape[1]]),
                                  x, np.zeros((1, x.shape[1]), bool)), cfg,
                                 self._nar_generator(seed))
                skip_front = raw_prompt_len if cfg.deep_clone else 0
                self.last_grid = grid[0, skip_front:]

            with timer.stage("vocode"):
                audio = self.vocode(self.last_grid)

            with timer.stage("trim"):
                audio, _ = trim(audio, top_db=cfg.trim_db)

            self.last_timing = timer.report(audio_seconds=len(audio) / self.sr)
            self.last_timing["grid_audio_s"] = (len(self.last_grid) * self.vocos.cfg.hop_length
                                                / self.sr)
            self._report_expert_load()
            return gen_codes, audio

    def _sampling(self, cfg: InferenceConfig, n_phones_gen: int) -> ArSampling:
        max_len = cfg.generate_max_len_override if cfg.generate_max_len_override > 1 else 2000
        return ArSampling(
            temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
            typical_p=cfg.typical_p, alpha_frequency=cfg.freq_penalty,
            alpha_presence=cfg.presence_penalty, penalty_window=cfg.rep_penalty_window,
            eos_penalty_decay=cfg.eos_penalty_decay,
            eos_penalty_factor=cfg.eos_penalty_factor, n_phones_gen=n_phones_gen,
            eos_idx=len(self.texttok.vocab) + self.speechtok.special_tokens["<|endofspeech|>"],
            valid_start=self._valid_window[0], valid_end=self._valid_window[1],
            max_len=max_len)

    def _nar_generator(self, seed: int) -> torch.Generator:
        """The diffusion's generator for a request of ``seed``, seeded
        ``seed + 1`` (the AR draws from ``seed``)."""
        return torch.Generator(device=self.device).manual_seed(seed + 1)

    def _nar(self, batch, cfg: InferenceConfig, generator: torch.Generator,
             deep_clone: Optional[bool] = None):
        """The NAR diffusion over ``batch`` (the engine's tuple) on this
        model's routes, guidance interval and buckets, drawing from
        ``generator``; ``deep_clone`` defaults to ``cfg.deep_clone``. Returns
        the (bs, Lx, 8) grid."""
        T = cfg.timesteps or self.default_T
        diff = MultinomialDiffusion(self.diffusion_n_classes, timesteps=T, device=self.device)
        dsh = DSH(last_greedy=True, x_0_temp=cfg.x_0_temp, guidance_w=cfg.nar_guidance_w,
                  deep_clone=cfg.deep_clone if deep_clone is None else deep_clone,
                  jump_len=1, jump_n_sample=1, q0_override_steps=cfg.q0_override_steps,
                  enable_kevin_scaled_inference=True, progress=False,
                  guidance_interval=self.guidance_interval)
        return perform_simple_inference(self.codecnar, batch, diff, T, dsh, retain_quant0=True,
                                        generator=generator, tail=self.nar_tail,
                                        mega=self._get_mega(), options=self.nar_options,
                                        gen_bucket=self.nar_gen_bucket,
                                        text_bucket=self.nar_text_bucket)

    def _synthesize_codes(self, text, ref_audio, ref_transcript, cfg, seed, timer):
        """Text and reference prep, AR decode and parse. Returns
        (text_tokens, prompt_codec (1, n_q, S) tensor, S, generated L0 ids)."""
        if cfg.deep_clone and ref_transcript is None:
            raise AssertionError(
                "Inference config deep clone is set to true, but reference "
                "transcript not specified! Please specify the transcript of the "
                "prompt, or set deep_clone=False in the inference `cfg` argument.")
        ref_audio = np.asarray(ref_audio, np.float32)
        if ref_audio.shape[-1] / self.sr > cfg.max_prompt_dur:
            logging.warning("Reference audio duration is %.2f > max suggested ref "
                            "audio. Expect quality degradations.",
                            ref_audio.shape[-1] / self.sr)

        with timer.stage("tokenize_text"):
            text_tokens = self.texttok.encode(
                "<|startoftext|>" + text.strip() + "<|endoftext|>", allowed_special="all")
            # computed even for shallow clone, as the reference does (so
            # ref_transcript=None raises TypeError there; pass "")
            text_tokens_full = self.texttok.encode(
                "<|startoftext|>" + ref_transcript + " " + str(text).strip()
                + "<|endoftext|>", allowed_special="all")

        with timer.stage("encode_reference"):
            if ref_audio.ndim == 1:
                ref_audio = ref_audio[None]
            if ref_audio.shape[0] != 1:
                ref_audio = ref_audio.mean(axis=0, keepdims=True)
            ref_audio = np.pad(ref_audio, ((0, 0), (int(self.sr * cfg.ref_audio_pad), 0)))
            prompt_codec = self.encode_reference(ref_audio[0])   # (1, n_q, S)
            codes_np = prompt_codec.cpu().numpy()

        with timer.stage("tokenize_speech"):
            speech_tokens = self.speechtok.encode(
                " ".join(str(t) for t in codes_np[0, 0].tolist()).strip())
            raw_prompt_len = codes_np.shape[-1]
            offset_speech = [p + len(self.texttok.vocab) for p in speech_tokens]
            n_speech_inp = 0
            if cfg.deep_clone:
                text_tokens = text_tokens_full
                n_speech_inp = len(offset_speech)
            else:
                offset_speech = []
            prompt = np.asarray(text_tokens + offset_speech, np.int64)
            first_codec_idx = prompt.shape[-1] - n_speech_inp + 1

        with timer.stage("ar_generate"):
            self._reset_expert_load()
            sampling = self._sampling(cfg, round(cfg.eos_estimated_gen_length_factor
                                                 * len(text)))
            max_len = sampling.max_len
            if not cfg.use_kv_cache:        # the JAX package's routing: the bf16 model
                ar_codes, _ = ar_generate_nocache(self.codeclm, prompt, codes_np[0].T,
                                                  sampling=sampling, seed=seed)
            else:
                ar_codes, _ = ar_generate(self.codeclm, prompt, codes_np[0].T,
                                          sampling=sampling, seed=seed,
                                          engine=self._ar_engine(max_len))
            self._last_ar_runaway = len(ar_codes) >= max_len - 1
            if self._last_ar_runaway:
                logging.warning("[autoregressive generation] output length = %d -- "
                                "inference likely failed or input too long!",
                                len(ar_codes))

        with timer.stage("parse_ar"):
            out = np.clip(ar_codes - len(self.texttok.vocab), 0, None)
            decoded = self.speechtok.decode_int(out[first_codec_idx:].tolist())
            gen_codes = np.asarray([s for s in decoded if isinstance(s, int)], np.int64)
        return text_tokens, prompt_codec, raw_prompt_len, gen_codes

    @torch.inference_mode()
    def tts_batch(self, texts, ref_audio, ref_transcript=None,
                  cfg: Optional[InferenceConfig] = None, seed: int = 0):
        """Synthesize several ``texts`` with one shared voice (``ref_audio``
        one waveform) or one voice a text (a list of ``len(texts)``
        waveforms, ``ref_transcript`` then a matching list). Returns one
        ``(ar_codes (Lgen,) int64 L0 ids, waveform (T,) float32 24 kHz)`` per
        text, as ``tts`` does; ``last_timing`` is over the total audio (its
        ``grid_audio_s``: the rows' served frames summed, x the hop / 24,000).

        The AR runs the quantized batched engine (K2, one call a step for all
        rows) for 2 to 8 rows with ``ar_backend="fused"``/``"fused4"`` and the
        cache on, and the bf16 batched engine (K7) otherwise: the routing of
        the JAX package's ``tts_batch``, kept as its semantics, not a device
        fallback. The AR draws from ``seed``, the diffusion from ``seed + 1``.
        """
        with span("request"):
            cfg = cfg or InferenceConfig()
            timer = StageTimer(sync=self._sync)
            n = len(texts)
            per_row_refs = isinstance(ref_audio, (list, tuple))
            refs = list(ref_audio) if per_row_refs else [ref_audio]
            if per_row_refs and len(refs) != n:
                raise ValueError(f"{len(refs)} reference audios != {n} texts")
            if isinstance(ref_transcript, (list, tuple)):
                transcripts = list(ref_transcript)
                if len(transcripts) != len(refs):
                    raise ValueError("per-row transcripts must match ref_audio")
            else:
                transcripts = [ref_transcript] * len(refs)
            if cfg.deep_clone and any(t is None for t in transcripts):
                raise AssertionError(
                    "Inference config deep clone is set to true, but reference "
                    "transcript not specified! Please specify the transcript of the "
                    "prompt, or set deep_clone=False in the inference `cfg` argument.")

            with timer.stage("encode_reference"):
                codec_per_ref = [self.encode_reference(r).cpu().numpy() for r in refs]
            row = (lambda per_ref: per_ref) if per_row_refs else (lambda per_ref: per_ref[:1] * n)
            row_codec = row(codec_per_ref)                  # (1, n_q, S_i) a row
            row_transcript = row(transcripts)
            skip_fronts = [c.shape[-1] if cfg.deep_clone else 0 for c in row_codec]

            with timer.stage("tokenize"):
                row_speech = row([[p + len(self.texttok.vocab) for p in self.speechtok.encode(
                    " ".join(str(t) for t in c[0, 0].tolist()).strip())] for c in codec_per_ref])
                prompts, first_codec_idxs, text_rows, est_lens = [], [], [], []
                for text, tr, speech in zip(texts, row_transcript, row_speech):
                    if cfg.deep_clone:
                        tokens = self.texttok.encode("<|startoftext|>" + tr + " "
                                                     + str(text).strip() + "<|endoftext|>",
                                                     allowed_special="all")
                        prompt = tokens + speech
                        n_speech_inp = len(speech)
                    else:
                        tokens = self.texttok.encode("<|startoftext|>" + text.strip()
                                                     + "<|endoftext|>", allowed_special="all")
                        prompt, n_speech_inp = tokens, 0
                    prompts.append(np.asarray(prompt, np.int64))
                    first_codec_idxs.append(len(prompt) - n_speech_inp + 1)
                    text_rows.append(tokens)
                    est_lens.append(round(cfg.eos_estimated_gen_length_factor * len(text)))

            with timer.stage("ar_generate"):
                self._reset_expert_load()
                sampling = self._sampling(cfg, max(est_lens))
                spk_list = [c[0].T for c in row_codec]
                # the JAX tts_batch's routing: the bf16 engine at 1 row, above 8 and uncached
                engine = (self._ar_engine(sampling.max_len, n)
                          if cfg.use_kv_cache and 2 <= n <= 8 else None)
                outs = ar_generate_batched(self.codeclm, prompts, spk_list, sampling=sampling,
                                           seed=seed, est_lens=est_lens, engine=engine)

            with timer.stage("parse_ar"):
                rows = []
                for (seq, _), fci in zip(outs, first_codec_idxs):
                    toks = np.clip(seq - len(self.texttok.vocab), 0, None)[fci:].tolist()
                    rows.append(np.asarray([s for s in self.speechtok.decode_int(toks)
                                            if isinstance(s, int)], np.int64))

            with timer.stage("nar_diffusion"):
                lt = max(len(r) for r in text_rows)
                lx = max(max(len(r) for r in rows), 1)
                lc = max(c.shape[-1] for c in row_codec)
                c_text = np.zeros((n, lt), np.int64)
                x = np.zeros((n, lx, 8), np.int64)
                xpm = np.ones((n, lx), bool)
                c_codes = np.zeros((n, lc, 8), np.int64)
                for i, (tr, r, c) in enumerate(zip(text_rows, rows, row_codec)):
                    c_text[i, : len(tr)] = tr
                    x[i, : len(r)] = r[:, None]
                    xpm[i, : len(r)] = False
                    c_codes[i, : c.shape[-1]] = c[0].T
                grid = self._nar((c_text, c_codes, np.asarray([len(t) for t in text_rows]),
                                  np.asarray([c.shape[-1] for c in row_codec]), x, xpm),
                                 cfg, self._nar_generator(seed))
                # each row's own prompt crop, left-aligned for batched vocoding
                out_lens = [max(len(r) - sk, 0) for r, sk in zip(rows, skip_fronts)]
                grid_out = torch.zeros((n, max(max(out_lens), 1), 8), dtype=torch.long,
                                       device=grid.device)
                for i, (r, sk) in enumerate(zip(rows, skip_fronts)):
                    grid_out[i, : out_lens[i]] = grid[i, sk: len(r)]
                self.last_grid = grid_out

            with timer.stage("vocode"):
                if self.vocos is None:
                    raise RuntimeError("Vocos vocoder parameters were not provided")
                feats = codes_to_features(self.vocos.codebook_weights, grid_out.permute(2, 0, 1),
                                          bins=self.vocos.cfg.codebook_size)
                audio = self.vocos.decode(feats, 1).cpu().numpy()

            with timer.stage("trim"):
                hop = self.vocos.cfg.hop_length
                results = [(r, trim(audio[i, : out_lens[i] * hop], top_db=cfg.trim_db)[0])
                           for i, r in enumerate(rows)]

            self.last_timing = timer.report(
                audio_seconds=sum(len(w) for _, w in results) / self.sr)
            self.last_timing["grid_audio_s"] = sum(out_lens) * hop / self.sr
            self._report_expert_load()
            return results

    @classmethod
    def from_pretrained(cls, model_id: str = "CAMB-AI/MARS5-TTS", *,
                        revision: Optional[str] = None, cache_dir: Optional[str] = None,
                        **kwargs) -> "Mars5TTS":
        """``mars5_ar.safetensors`` and ``mars5_nar.safetensors`` of
        ``model_id`` through ``huggingface_hub.hf_hub_download`` when it
        imports; otherwise the first copy found under ``cache_dir``,
        ``MARS5_CACHE`` (default ``~/.cache/mars5_tts_torch``) or ``HF_HOME``
        (default ``~/.cache/huggingface``). Then ``from_local`` with
        ``kwargs``."""
        names = ("mars5_ar.safetensors", "mars5_nar.safetensors")
        try:
            from huggingface_hub import hf_hub_download
        except ImportError:
            hf_hub_download = None
        if hf_hub_download is not None:
            paths = [hf_hub_download(repo_id=model_id, filename=n, revision=revision,
                                     cache_dir=cache_dir) for n in names]
            return cls.from_local(paths[0], paths[1], **kwargs)
        search = [Path(cache_dir) if cache_dir else None,
                  Path(os.environ.get("MARS5_CACHE", "~/.cache/mars5_tts_torch")).expanduser(),
                  Path(os.environ.get("HF_HOME", "~/.cache/huggingface")).expanduser()]
        roots = [r for r in search if r is not None and r.exists()]
        paths = []
        for name in names:
            hits = [h for r in roots for h in sorted(r.rglob(name))]
            if not hits:
                raise FileNotFoundError(
                    f"{name} not found (huggingface_hub is not installed and there is no "
                    f"copy under {[str(r) for r in search if r]}); download the checkpoints "
                    f"and use Mars5TTS.from_local")
            paths.append(hits[0])
        return cls.from_local(paths[0], paths[1], **kwargs)
