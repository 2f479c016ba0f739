"""Text -> token ids (the character path of
``isp_tts_tpu/data/providers.py:TextProvider``)."""

from __future__ import annotations

import numpy as np

from .text.processor import process_text
from .text.table import CodingTable


class TextProvider:
    """Token ids from a coding table, or from a checkpoint's ``encoding_map``."""

    def __init__(self, coding_table: CodingTable | dict, phonemizer: bool = False):
        if phonemizer:
            raise NotImplementedError(
                "the phonemizer path is not ported yet (ROADMAP Queue 1 item 2, "
                "the data pipeline)")
        self.coding_table = (coding_table if isinstance(coding_table, CodingTable)
                             else CodingTable.from_encoding_map(coding_table))

    def __call__(self, text: str) -> np.ndarray:
        """int32 token ids of ``text``, end-of-sentence token included."""
        processed = self.coding_table.check_eos(process_text(text))
        return np.asarray(self.coding_table.text_to_vector(processed), np.int32)
