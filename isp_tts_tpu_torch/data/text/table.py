"""Character -> id coding table (counterpart of ``isp_tts_tpu/data/text/table.py``).

Serving builds it from a checkpoint's ``encoding_map``, whose ids index the
text-embedding rows and are used as they are, or from a charset of macro
names (``#punct``, ``#en``, ...): service tokens first, then the symbols in
order, each once.
"""

from __future__ import annotations

import logging
import re
from string import punctuation
from typing import Sequence

from . import symbols as sym

logger = logging.getLogger("isp_tts_tpu_torch")

_CHAR_SPLIT = re.compile(rf"(</?\w+>|[{re.escape(punctuation)}]|\w)")


def split_to_chars(text: str) -> list[str]:
    """Split text into single chars, keeping ``<tag>`` service tokens whole."""
    return [t for t in _CHAR_SPLIT.split(text) if t]


class CodingTable:
    def __init__(self, encoding_map: dict):
        self.encoding_map = {s: int(i) for s, i in encoding_map.items()}
        self.eos = sym.EOS if sym.EOS in self.encoding_map else None

    @classmethod
    def from_encoding_map(cls, encoding_map: dict) -> "CodingTable":
        """A checkpoint's symbol -> id table, its ids as they are."""
        return cls(dict(sorted(encoding_map.items(), key=lambda kv: int(kv[1]))))

    @classmethod
    def from_charset(cls, charset: str | Sequence[str]) -> "CodingTable":
        """The table a charset names: ``<pad>`` then ``</s>`` (where named),
        then the other symbols in order, macros expanded, each once."""
        if isinstance(charset, str):
            charset = [charset]
        service = [t for t in (sym.PAD, sym.EOS) if t in charset]
        vocab: list[str] = []
        for item in charset:
            if item in service:
                continue
            if item.startswith("<") and item.endswith(">"):
                vocab.append(item)
            else:
                vocab.extend(sym.CHARSET_MAP.get(item, list(item)))
        symbols = service + list(dict.fromkeys(vocab))
        return cls({s: i for i, s in enumerate(symbols)})

    def check_eos(self, text: str) -> str:
        if self.eos is not None and not text.endswith(self.eos):
            return text + self.eos
        return text

    def text_to_vector(self, text: str) -> list[int]:
        """Ids of the known characters; unknown ones are dropped with a warning."""
        unknown: set[str] = set()
        vector = []
        for ch in split_to_chars(text):
            if ch in self.encoding_map:
                vector.append(self.encoding_map[ch])
            else:
                unknown.add(ch)
        if unknown:
            logger.warning("Coding table is missing characters: %s", sorted(unknown))
        return vector
