"""Text processing: cleaners, the always-on punctuation corrector,
lowercase, then the phonemizer when one is asked for (counterpart of
``isp_tts_tpu/data/text/processor.py``). ``phonemizer=True`` builds
espeak-ng's backend; ``phonemizer_backend`` injects another one."""

from __future__ import annotations

from typing import Callable

from .cleaners import CLEANERS, punct_corrector


class TextProcessor:
    def __init__(self, cleaners: list[str | Callable] | None = None,
                 language: str = "en-us", phonemizer: bool = False,
                 phonemizer_backend=None):
        self.cleaners = [CLEANERS[c] if isinstance(c, str) else c
                         for c in cleaners or []] + [punct_corrector]
        self.language = language
        self.phonemizer = None
        if phonemizer or phonemizer_backend is not None:
            from .phonemes import Phonemizer

            self.phonemizer = Phonemizer(language=language, backend=phonemizer_backend)

    def __call__(self, text: str, mask_phonemes: bool | float = False) -> str:
        for cleaner in self.cleaners:
            text = cleaner(text)
        text = text.lower()
        if self.phonemizer is not None:
            text = self.phonemizer(text, mask_phonemes=mask_phonemes)
        return text


def process_text(text: str) -> str:
    """The serving chain: ``punct_corrector``, then lowercase."""
    return punct_corrector(text).lower()
