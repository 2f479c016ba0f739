"""Text processing: cleaners, the always-on punctuation corrector, then
lowercase (counterpart of ``isp_tts_tpu/data/text/processor.py`` without
its phonemizer, which is not ported yet)."""

from __future__ import annotations

from typing import Callable

from .cleaners import CLEANERS, punct_corrector


class TextProcessor:
    def __init__(self, cleaners: list[str | Callable] | None = None,
                 phonemizer: bool = False):
        if phonemizer:
            raise NotImplementedError(
                "the phonemizer path is not ported yet (ROADMAP Queue 1 item 2, "
                "the data pipeline)")
        self.cleaners = [CLEANERS[c] if isinstance(c, str) else c
                         for c in cleaners or []] + [punct_corrector]

    def __call__(self, text: str) -> str:
        for cleaner in self.cleaners:
            text = cleaner(text)
        return text.lower()


def process_text(text: str) -> str:
    """The serving chain: ``punct_corrector``, then lowercase."""
    return punct_corrector(text).lower()
