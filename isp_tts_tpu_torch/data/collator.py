"""Pad-collation with shape bucketing (counterpart of
``isp_tts_tpu/data/collator.py``): padded lengths round up to bucket
multiples, or, with ``fixed_shape``, every batch pads to
(``max_text_len``, ``max_mel_len``) so a chunk of steps shares one shape.
The mel is channel-last, (B, frames, n_mels). Arrays stay numpy; the
trainer moves them to its device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .dataset import AcousticSample


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class AcousticCollatorConfig:
    text_pad_multiple: int = 16
    mel_pad_multiple: int = 64
    max_text_len: int | None = None
    max_mel_len: int | None = None
    #: pad every batch to (max_text_len, max_mel_len)
    fixed_shape: bool = False


class AcousticCollator:
    Config = AcousticCollatorConfig

    def __init__(self, config: AcousticCollatorConfig | None = None, **kw):
        self.config = config or AcousticCollatorConfig(**kw)

    def __call__(self, batch: Sequence[AcousticSample]) -> dict:
        cfg = self.config
        B = len(batch)
        ref = batch[0]
        n_mels = ref.mel.shape[1]

        text_lens = np.asarray([s.text_vector_len for s in batch], np.int32)
        mel_lens = np.asarray([s.mel_len for s in batch], np.int32)

        if cfg.fixed_shape:
            if cfg.max_text_len is None or cfg.max_mel_len is None:
                raise ValueError(
                    "fixed_shape collation requires max_text_len and max_mel_len")
            T, M = cfg.max_text_len, cfg.max_mel_len
        else:
            T = round_up(int(text_lens.max()), cfg.text_pad_multiple)
            M = round_up(int(mel_lens.max()), cfg.mel_pad_multiple)
            if cfg.max_text_len is not None:
                T = min(T, cfg.max_text_len)
            if cfg.max_mel_len is not None:
                M = min(M, cfg.max_mel_len)
        text_lens = np.minimum(text_lens, T)
        mel_lens = np.minimum(mel_lens, M)

        text = np.zeros((B, T), np.int32)
        mel = np.zeros((B, M, n_mels), np.float32)
        pitch = np.zeros((B, M), np.float32) if ref.pitch is not None else None
        energy = np.zeros((B, M), np.float32) if ref.energy is not None else None
        speaker = np.zeros((B,), np.int32) if ref.speaker is not None else None

        for i, s in enumerate(batch):
            tl, ml = int(text_lens[i]), int(mel_lens[i])
            text[i, :tl] = s.text_vector[:tl]
            mel[i, :ml] = s.mel[:ml]
            if pitch is not None:
                pitch[i, :ml] = s.pitch[:ml]
            if energy is not None:
                energy[i, :ml] = s.energy[:ml]
            if speaker is not None:
                speaker[i] = s.speaker

        out = {
            "filename": [s.filename for s in batch],
            "text": [s.text for s in batch],
            "text_vector": text,
            "text_vector_len": text_lens,
            "mel": mel,
            "mel_len": mel_lens,
        }
        if pitch is not None:
            out["pitch"] = pitch
        if energy is not None:
            out["energy"] = energy
        if speaker is not None:
            out["speaker"] = speaker
        return out
