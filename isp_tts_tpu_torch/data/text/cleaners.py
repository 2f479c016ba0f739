"""The always-on text cleaner (from ``isp_tts_tpu/data/text/cleaners.py``).

Serving runs ``punct_corrector`` alone, as the JAX package's text provider
does; the optional cleaner chains of training recipes are not ported yet.
"""

from __future__ import annotations

import re

_WHITESPACE = re.compile(r"\s+")
_BRACKETS = re.compile(r"[\[\]\{\}]")
_UNICODE_QUOTES = re.compile(r"[“”„«»]")
_UNICODE_HYPHENS = re.compile(r"[‐‑‒–―]")
_TRAILING_JUNK_DOT = re.compile(r"[, \n]+\.$")
_LEADING_PUNCT = re.compile(r"^[?!., -]+")


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE.sub(" ", text)


def punct_corrector(text: str) -> str:
    """Normalise punctuation without changing words."""
    text = text.strip()
    text = _BRACKETS.sub("", text)
    text = _UNICODE_HYPHENS.sub("-", text)
    text = _UNICODE_QUOTES.sub('"', text)
    text = text.replace("…", "...")
    text = _TRAILING_JUNK_DOT.sub(".", text)
    text = _LEADING_PUNCT.sub("", text)
    return collapse_whitespace(text)
