"""Text cleaners (counterpart of ``isp_tts_tpu/data/text/cleaners.py``).

``punct_corrector`` always runs last; ``basic_cleaners`` and
``english_cleaners`` are the optional chains a text processor may put
before it. ``convert_to_ascii`` uses ``unidecode`` where it is installed
and drops non-ASCII characters otherwise, as there.
"""

from __future__ import annotations

import re

_WHITESPACE = re.compile(r"\s+")
_BRACKETS = re.compile(r"[\[\]\{\}]")
_UNICODE_QUOTES = re.compile(r"[“”„«»]")
_UNICODE_HYPHENS = re.compile(r"[‐‑‒–―]")
_TRAILING_JUNK_DOT = re.compile(r"[, \n]+\.$")
_LEADING_PUNCT = re.compile(r"^[?!., -]+")


_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE.sub(" ", text)


def lowercase(text: str) -> str:
    return text.lower()


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def convert_to_ascii(text: str) -> str:
    try:
        from unidecode import unidecode

        return unidecode(text)
    except ImportError:
        return text.encode("ascii", errors="ignore").decode()


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def english_cleaners(text: str) -> str:
    return collapse_whitespace(expand_abbreviations(lowercase(convert_to_ascii(text))))


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


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "english_cleaners": english_cleaners,
    "punct_corrector": punct_corrector,
}
