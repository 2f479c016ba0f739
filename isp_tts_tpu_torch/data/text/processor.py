"""Text processing for serving: the punctuation cleaner, then lowercase
(``isp_tts_tpu/data/text/processor.py`` with no extra cleaners and no
phonemizer, as serving builds it; the phonemizer path is not ported yet)."""

from __future__ import annotations

from .cleaners import punct_corrector


def process_text(text: str) -> str:
    return punct_corrector(text).lower()
