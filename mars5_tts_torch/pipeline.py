"""Mars5TTS, the public synthesis API
(counterpart of ``mars5_tts_tpu/pipeline.py``).

tokenize -> Encodec-encode the reference -> speech-BPE its L0 codes -> deep or
shallow prompt -> AR decode -> parse -> NAR diffusion -> Vocos -> silence
trim, step for step as the JAX package (and the reference) does it.

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

Not ported yet: ``tts_batch``, grouped NAR quantization,
``use_kv_cache=False``, the guidance interval and geometry buckets.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .audio.trim import trim
from .config import DSH, InferenceConfig
from .diffusion.engine import TAILS, perform_simple_inference
from .diffusion.multinomial import MultinomialDiffusion
from .hub import load_checkpoint, load_tokenizers
from .models.ar import CodecLM, CodecLMConfig
from .models.ar_decode import ArSampling, ar_generate, ar_vocab_window
from .models.ar_decode_fused import ar_generate_fused, prepare_fused
from .models.convert import (infer_codeclm_config, infer_nar_config, load_codeclm,
                             load_nar)
from .models.encodec import EncodecConfig, EncodecEncoder, encodec_from_pytree
from .models.nar import ResidualTransformer, ResidualTransformerConfig
from .models.vocos import Vocos, VocosConfig, vocos_from_pytree
from .ops.kernels.decode_layer import make_dims
from .ops.kernels.nar_mega import build_mega_pack, mega_supported
from .ops.quant import quantize_nar
from .utils.profiling import StageTimer


def default_device() -> torch.device:
    """The card when PyTorch sees one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
                 nar_tail: str = "heads"):
        """From reference-layout checkpoints ({'vocab', 'model'[, 'config']}),
        with Encodec/Vocos given as the JAX package's parameter pytrees.
        ``device`` defaults to ``default_device()``. ``nar_backend="int8"``
        quantizes the NAR after loading, unless its checkpoint is already
        quantized; ``ar_backend``, ``head4``, ``nar_mega`` and ``nar_tail`` as
        in the module docstring."""
        device = torch.device(device) if device is not None else default_device()
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
                    ar_backend, nar_backend, head4, nar_mega, nar_tail)

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
                    nar_tail: str = "heads") -> "Mars5TTS":
        """From already-built port modules and tokenizer objects. With
        ``nar_backend="int8"`` a bf16/f32 ``codecnar`` is quantized into a new
        module (the given one is left as it was); a quantized one is used as
        it is. The quantized AR backends leave ``codeclm`` as it is. The
        device defaults to that of ``codeclm``'s weights."""
        self = cls.__new__(cls)
        device = device or codeclm.embed.weight.device
        self._setup(codeclm, codecnar, texttok, speechtok, encodec, vocos, device,
                    ar_backend, nar_backend, head4, nar_mega, nar_tail)
        return self

    def _setup(self, codeclm, codecnar, texttok, speechtok, encodec, vocos, device,
               ar_backend, nar_backend, head4, nar_mega, nar_tail):
        if ar_backend not in ("bf16", "fused", "fused4"):
            raise ValueError(f"unknown ar_backend {ar_backend!r}")
        if head4 and ar_backend != "fused4":
            raise ValueError("head4=True needs ar_backend='fused4'")
        self.ar_backend, self.head4 = ar_backend, head4
        self._fused_cache: dict = {}
        self._mega_pack = None
        if nar_backend not in ("bf16", "int8"):
            raise ValueError(f"unknown nar_backend {nar_backend!r}")
        if nar_backend == "int8" and not codecnar.is_quantized:
            codecnar = quantize_nar(codecnar)
        elif nar_backend == "bf16" and codecnar.is_quantized:
            raise ValueError("a quantized NAR needs nar_backend='int8'")
        if nar_tail not in TAILS:
            raise ValueError(f"unknown nar_tail {nar_tail!r}")
        if (nar_mega or nar_tail != "heads") and nar_backend != "int8":
            raise ValueError("nar_mega and nar_tail need nar_backend='int8'")
        if nar_mega and not mega_supported(codecnar.tfm.decoder):
            raise ValueError("nar_mega=True: the NAR decoder's geometry does not fit kernel "
                             "K9 (head dim 64, D and F multiples of 128 up to 3072)")
        self.nar_backend, self.nar_mega, self.nar_tail = nar_backend, nar_mega, nar_tail
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

    def _get_fused(self, max_len: int):
        """The quantized decode pack and dims for ``max_len``, built at first
        use and kept per ``max_len``; the weights are packed once and shared."""
        if max_len not in self._fused_cache:
            wbits = 4 if self.ar_backend == "fused4" else 8
            if self._fused_cache:
                fp, _ = next(iter(self._fused_cache.values()))
                dims = make_dims(self.ar_cfg, max_len, wbits)
            else:
                fp, dims = prepare_fused(self.codeclm, max_len, wbits, self.head4)
            self._fused_cache[max_len] = (fp, dims)
        return self._fused_cache[max_len]

    def _get_mega(self):
        """The K9 operand bundle of the int8 NAR decoder, built at the first
        ``nar_mega`` request and kept (None without ``nar_mega``)."""
        if self.nar_mega and self._mega_pack is None:
            self._mega_pack = build_mega_pack(self.codecnar.tfm.decoder)
        return self._mega_pack

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
        """
        if max_retries:
            for attempt in range(max_retries + 1):
                result = self.tts(text, ref_audio, ref_transcript, cfg,
                                  seed=seed + 1000 * attempt)
                if not self._last_ar_runaway or attempt == max_retries:
                    return result
                logging.warning("runaway AR decode; retrying (%d/%d)", attempt + 1,
                                max_retries)
        cfg = cfg or InferenceConfig()
        if not cfg.use_kv_cache:
            raise NotImplementedError("use_kv_cache=False is not ported")
        timer = StageTimer(sync=self._sync)
        text_tokens, prompt_codec, raw_prompt_len, gen_codes = self._synthesize_codes(
            text, ref_audio, ref_transcript, cfg, seed, timer)

        with timer.stage("nar_diffusion"):
            c_codes = prompt_codec.transpose(1, 2)
            x = np.repeat(gen_codes[None, :, None], 8, axis=2)
            T = cfg.timesteps or self.default_T
            diff = MultinomialDiffusion(self.diffusion_n_classes, timesteps=T,
                                        device=self.device)
            dsh = DSH(last_greedy=True, x_0_temp=cfg.x_0_temp,
                      guidance_w=cfg.nar_guidance_w, deep_clone=cfg.deep_clone,
                      jump_len=1, jump_n_sample=1,
                      q0_override_steps=cfg.q0_override_steps,
                      enable_kevin_scaled_inference=True, progress=False)
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            grid = perform_simple_inference(
                self.codecnar,
                (np.asarray(text_tokens, np.int64)[None], c_codes,
                 np.asarray([len(text_tokens)]), np.asarray([c_codes.shape[1]]), x,
                 np.zeros((1, x.shape[1]), bool)),
                diff, T, dsh, retain_quant0=True, generator=gen, tail=self.nar_tail,
                mega=self._get_mega())
            skip_front = raw_prompt_len if cfg.deep_clone else 0
            self.last_grid = grid[0, skip_front:]

        with timer.stage("vocode"):
            audio = self.vocode(self.last_grid)

        with timer.stage("trim"):
            audio, _ = trim(audio, top_db=cfg.trim_db)

        self.last_timing = timer.report(audio_seconds=len(audio) / self.sr)
        return gen_codes, audio

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
            max_len = (cfg.generate_max_len_override
                       if cfg.generate_max_len_override > 1 else 2000)
            sampling = ArSampling(
                temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
                typical_p=cfg.typical_p, alpha_frequency=cfg.freq_penalty,
                alpha_presence=cfg.presence_penalty,
                penalty_window=cfg.rep_penalty_window,
                eos_penalty_decay=cfg.eos_penalty_decay,
                eos_penalty_factor=cfg.eos_penalty_factor,
                n_phones_gen=round(cfg.eos_estimated_gen_length_factor * len(text)),
                eos_idx=len(self.texttok.vocab)
                + self.speechtok.special_tokens["<|endofspeech|>"],
                valid_start=self._valid_window[0], valid_end=self._valid_window[1],
                max_len=max_len)
            if self.ar_backend == "bf16":
                ar_codes, _ = ar_generate(self.codeclm, prompt, codes_np[0].T,
                                          sampling=sampling, seed=seed)
            else:
                fp, dims = self._get_fused(max_len)
                ar_codes, _ = ar_generate_fused(self.codeclm, fp, dims, prompt,
                                                codes_np[0].T, sampling=sampling, seed=seed)
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
