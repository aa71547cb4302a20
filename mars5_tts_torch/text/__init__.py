"""The minbpe tokenizers (the port's own copy of ``mars5_tts_tpu/text``)."""

from .minbpe import CodebookTokenizer, GPT4_SPLIT_PATTERN, RegexTokenizer

__all__ = ["CodebookTokenizer", "GPT4_SPLIT_PATTERN", "RegexTokenizer"]
