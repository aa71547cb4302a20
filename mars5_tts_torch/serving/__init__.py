"""Serving (counterpart of ``mars5_tts_tpu/serving``): on one device,
continuous batching of the AR over a pool of rows, NAR waves, long-form
narration and progressive intra-utterance streaming; across devices, the
data-parallel decoders of ``serving.multichip`` (imported on its own: it
needs ``torch.distributed``)."""

from .continuous import ContinuousBatcher, Request
from .longform import (LongformResult, StreamChunk, chunk_text, crossfade_concat,
                       stream_longform, synthesize_longform)
from .progressive import ProgressiveChunk, progressive_tts, stream_tts

__all__ = ["ContinuousBatcher", "LongformResult", "ProgressiveChunk", "Request", "StreamChunk",
           "chunk_text", "crossfade_concat", "progressive_tts",
           "stream_longform", "stream_tts", "synthesize_longform"]
