"""Character -> id coding table (counterpart of ``isp_tts_tpu/data/text/table.py``).

Serving builds it from a checkpoint's ``encoding_map``, whose ids index the
text-embedding rows and are used as they are.
"""

from __future__ import annotations

import logging
import re
from string import punctuation

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
