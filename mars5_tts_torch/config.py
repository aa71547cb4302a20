"""Public inference configuration surfaces.

``InferenceConfig`` reproduces the reference dataclass field-for-field
(reference: inference.py:24-77) — it is the complete user-tunable surface of
``Mars5TTS.tts``. ``DSH`` mirrors the internal diffusion-sampling hyperparameters
(reference: mars5/diffuser.py:302-315).

The port's own copy of ``mars5_tts_tpu/config.py`` (field for field the
same), so that ``mars5_tts_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class InferenceConfig:
    """The default configuration variables for TTS inference.

    Field names, defaults, and semantics match the reference ``InferenceConfig``
    (inference.py:24-77) exactly.
    """

    # >>>> AR CONFIG
    # Sampling temperature: T>1 favours less probable outputs, T<1 reduces randomness.
    temperature: float = 0.7
    # Keep only the top_k highest-probability tokens (0 disables).
    top_k: int = 200
    # Nucleus sampling: keep top tokens with cumulative probability >= top_p (1.0 disables).
    top_p: float = 0.2

    typical_p: float = 1.0
    freq_penalty: float = 3        # penalize repeated tokens
    presence_penalty: float = 0.4  # penalize any previously-seen token
    rep_penalty_window: int = 80   # lookback window for the penalties (~5 s of codes)

    eos_penalty_decay: float = 0.5
    eos_penalty_factor: float = 1
    # multiple of len(text) (in characters) used as the estimated output length
    eos_estimated_gen_length_factor: float = 1.0

    # >>>> NAR CONFIG
    timesteps: int = 200
    x_0_temp: float = 0.7
    q0_override_steps: int = 20  # steps where AR L0 codes override NAR L0 predictions
    nar_guidance_w: float = 3

    max_prompt_dur: float = 12  # maximum reference-prompt duration, seconds

    # Maximum AR codes to generate in one inference; -1 keeps the train-time default (2000).
    generate_max_len_override: int = -1

    # Deep clone: condition the AR on the reference transcript + codes. Better
    # cloning/intelligibility; requires the transcript and takes a bit longer.
    deep_clone: bool = True

    # KV caching toggles the fast decode path; it does not affect output quality.
    use_kv_cache: bool = True

    # Silence trim threshold (dB below peak) applied to the final output.
    trim_db: float = 27
    beam_width: int = 1  # only beam width 1 is currently supported

    ref_audio_pad: float = 0


@dataclass(frozen=True)
class DSH:
    """Diffusion Sampling Hyperparameters (reference: mars5/diffuser.py:302-315)."""

    jump_len: int = 1          # j in the RePaint paper
    jump_n_sample: int = 1     # r in the RePaint paper
    last_greedy: bool = False  # argmax instead of sampling at t=0
    x_0_temp: float = 1.0      # temperature on the model's x0 prediction
    guidance_w: float = 1.0    # classifier-free guidance weight
    enable_kevin_scaled_inference: bool = True  # sequentially-progressive diffusion
    T_override: Optional[int] = None

    deep_clone: bool = False
    q0_override_steps: int = 0
    progress: bool = False
    # Beyond-reference serving dial: apply classifier-free guidance only while
    # t/T is inside [lo, hi) — steps outside run the conditional forward alone
    # (half the decoder batch, ~45% cheaper per step). (0, 1) = reference
    # behavior (guidance every step); guidance-interval literature
    # (Kynkäänniemi et al. 2024) motivates restricting CFG to the noisier part
    # of the trajectory. Scored like every quality mode by
    # scripts/bench_quality_modes.py's reseed-floor criterion.
    guidance_interval: tuple = (0.0, 1.0)
