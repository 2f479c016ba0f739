"""Dataset metadata: ``|``-separated meta files with named fields
(counterpart of ``isp_tts_tpu/data/metadata.py``)."""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass
from pathlib import Path

from .audio import wav_duration

logger = logging.getLogger("isp_tts_tpu_torch")

DEFAULT_FIELDS = ("audio_path", "text")


@dataclass
class MetaRecord:
    audio_path: str
    text: str
    speaker: str | None = None
    mel: str | None = None
    pitch: str | None = None
    energy: str | None = None


class TTSMeta:
    """The records of a ``|``-separated meta file."""

    def __init__(self, records: list[MetaRecord], fields: tuple[str, ...] = DEFAULT_FIELDS):
        self.records = records
        self.fields = fields

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> MetaRecord:
        return self.records[idx]

    def __iter__(self):
        return iter(self.records)

    @classmethod
    def load(cls, path: str | Path, fields: tuple[str, ...] = DEFAULT_FIELDS,
             delimiter: str = "|") -> "TTSMeta":
        records = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    records.append(MetaRecord(**dict(zip(fields, line.split(delimiter)))))
        return cls(records, fields)

    def save(self, path: str | Path, delimiter: str = "|") -> None:
        with open(path, "w", encoding="utf-8") as f:
            for r in self.records:
                parts = [getattr(r, field) or "" for field in self.fields]
                f.write(delimiter.join(str(p) for p in parts) + "\n")

    def split(self, ratio: float = 0.1, seed: int = 42) -> tuple["TTSMeta", "TTSMeta"]:
        """(train, valid), ``ratio`` of the records (at least one) to valid."""
        order = list(range(len(self.records)))
        random.Random(seed).shuffle(order)
        valid_idx = set(order[:max(int(len(order) * ratio), 1)])
        train = [r for i, r in enumerate(self.records) if i not in valid_idx]
        valid = [r for i, r in enumerate(self.records) if i in valid_idx]
        return TTSMeta(train, self.fields), TTSMeta(valid, self.fields)

    def filter_length(self, min_len: int = 0, max_len: int | None = None) -> "TTSMeta":
        """Records whose text has between ``min_len`` and ``max_len`` characters."""
        kept = [r for r in self.records
                if len(r.text) >= min_len and (max_len is None or len(r.text) <= max_len)]
        if len(kept) != len(self.records):
            logger.info("filter_length: kept %d / %d records", len(kept), len(self.records))
        return TTSMeta(kept, self.fields)

    def filter_audio_length(self, data_root: str | Path, min_sec: float = 0.0,
                            max_sec: float | None = None) -> "TTSMeta":
        """Records whose audio lasts between ``min_sec`` and ``max_sec``
        (from each WAV header); unreadable files are skipped."""
        root = Path(data_root)
        kept = []
        for r in self.records:
            try:
                dur = wav_duration(root / r.audio_path)
            except Exception as e:  # noqa: BLE001 - a bad file is skipped, as there
                logger.warning("skipping %s: %s", r.audio_path, e)
                continue
            if dur >= min_sec and (max_sec is None or dur <= max_sec):
                kept.append(r)
        if len(kept) != len(self.records):
            logger.info("filter_audio_length: kept %d / %d", len(kept), len(self.records))
        return TTSMeta(kept, self.fields)
