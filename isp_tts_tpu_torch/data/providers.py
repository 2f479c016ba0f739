"""Text -> token ids (the character path of
``isp_tts_tpu/data/providers.py:TextProvider``)."""

from __future__ import annotations

import numpy as np

from .text.processor import process_text
from .text.table import CodingTable


class TextProvider:
    def __init__(self, encoding_map: dict):
        self.coding_table = CodingTable(encoding_map)

    def __call__(self, text: str) -> np.ndarray:
        """int32 token ids of ``text``, end-of-sentence token included."""
        processed = self.coding_table.check_eos(process_text(text))
        return np.asarray(self.coding_table.text_to_vector(processed), np.int32)
