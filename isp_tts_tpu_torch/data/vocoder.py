"""Vocoder dataset and collator: fixed-length waveform segments
(counterpart of ``isp_tts_tpu/data/vocoder.py``).

GAN vocoder training takes raw audio crops (the mel features are computed
on the card inside the step), so the host path loads the WAV (cached),
cuts a ``segment_samples`` crop and stacks. Training crops start at
``np.random.randint`` of numpy's global generator, one draw per sample in
the loader's order, as the JAX package draws (the trainer's ``epoch_seed``
callback reseeds it each epoch), so one seed gives the JAX package's
crops; evaluation (``random_crop: false``) takes centre crops. With
``mel_dir`` each clip has a paired predicted mel ``<wav stem>.npy`` of
(T, n_mels): the audio is cut to T * hop, crops snap to the hop, and a
short clip's mel is padded with log(1e-5), the log-mel of the silence its
audio is padded with. A batch's uncached WAVs decode together on the
native thread pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

from ..config.registry import build_config
from . import providers as dp
from .metadata import TTSMeta


@dataclass
class VocoderSample:
    filename: str
    audio: np.ndarray  # (segment_samples,) float32
    n_samples: int  # the crop's samples before padding
    #: the paired mel crop (segment_samples // hop_length, n_mels), or None
    mel: np.ndarray | None = None


@dataclass
class VocoderDatasetConfig:
    root: str = None  # type: ignore
    meta_name: str = "meta.csv"
    meta_column_names: tuple = ("audio_path", "text")
    audio: dict = None  # type: ignore
    segment_samples: int = 16384
    #: random crops for training; centre crops otherwise
    random_crop: bool = True
    audio_length_limits: tuple | None = None
    cache_audio: bool = True
    #: directory of per-clip predicted mels ``<wav stem>.npy``
    mel_dir: str | None = None
    #: samples per mel frame (crop alignment with ``mel_dir``)
    hop_length: int = 256


class VocoderDataset:
    Config = VocoderDatasetConfig

    def __init__(self, config: VocoderDatasetConfig, device=None):
        """``device`` is accepted, as the experiment passes it to every
        dataset, and unused: the crops are cut on the host."""
        cfg = self.config = config
        if cfg.root is None:
            raise ValueError("dataset root is required")
        self.data_root = cfg.root
        meta = TTSMeta.load(str(Path(cfg.root, cfg.meta_name)), tuple(cfg.meta_column_names))
        if cfg.audio_length_limits is not None:
            meta = meta.filter_audio_length(cfg.root, *list(cfg.audio_length_limits))
        self.meta = meta
        self.audio_provider = dp.AudioProvider(
            build_config(dp.AudioProviderConfig, cfg.audio or {}))
        self._cache: dict[int, np.ndarray] | None = {} if cfg.cache_audio else None

    def __len__(self) -> int:
        return len(self.meta)

    def _path(self, idx: int) -> Path:
        return Path(self.data_root, self.meta[idx].audio_path)

    def _audio(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        audio = np.asarray(self.audio_provider(self._path(idx)), np.float32)
        if self._cache is not None:
            self._cache[idx] = audio
        return audio

    def _mel(self, idx: int) -> np.ndarray:
        stem = Path(self.meta[idx].audio_path).stem
        return np.load(Path(self.config.mel_dir) / f"{stem}.npy")

    def __getitem__(self, idx: int) -> VocoderSample:
        return self._sample(idx, self._audio(idx))

    def get_batch(self, indices: list[int]) -> list[VocoderSample]:
        """The samples of ``indices``, in order; the WAVs not cached yet
        decode together (:meth:`AudioProvider.load_batch`)."""
        cached = self._cache or {}
        todo = sorted({i for i in indices if i not in cached})
        loaded = dict(zip(todo, (np.asarray(a, np.float32) for a in
                                 self.audio_provider.load_batch([self._path(i) for i in todo]))))
        if self._cache is not None:
            self._cache.update(loaded)
        return [self._sample(i, cached[i] if i in cached else loaded[i]) for i in indices]

    def _sample(self, idx: int, audio: np.ndarray) -> VocoderSample:
        cfg = self.config
        seg, hop = cfg.segment_samples, cfg.hop_length
        paired = cfg.mel_dir is not None
        mel = None
        if paired:
            # the predicted mel has T frames: the audio is cut to T * hop
            full_mel = self._mel(idx)
            audio = audio[: full_mel.shape[0] * hop]
        n = audio.shape[-1]
        if n >= seg:
            if cfg.random_crop:
                start = int(np.random.randint(0, n - seg + 1))
            else:
                start = (n - seg) // 2
            if paired:
                start = (start // hop) * hop
            crop = audio[start:start + seg]
            n_valid = seg
        else:
            start = 0
            crop = np.pad(audio, (0, seg - n))
            n_valid = n
        if paired:
            frames = seg // hop
            mel = full_mel[start // hop: start // hop + frames]
            if mel.shape[0] < frames:
                mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)),
                             constant_values=float(np.log(1e-5)))
            mel = np.ascontiguousarray(mel, np.float32)
        return VocoderSample(filename=self.meta[idx].audio_path,
                             audio=np.ascontiguousarray(crop, np.float32), n_samples=n_valid,
                             mel=mel)


@dataclass
class VocoderCollatorConfig:
    pass


class VocoderCollator:
    Config = VocoderCollatorConfig

    def __init__(self, config: VocoderCollatorConfig | None = None, **kw):
        self.config = config or VocoderCollatorConfig(**kw)

    def __call__(self, batch: Sequence[VocoderSample]) -> dict:
        out = {"filename": [s.filename for s in batch],
               "audio": np.stack([s.audio for s in batch]),
               "n_samples": np.asarray([s.n_samples for s in batch], np.int32)}
        if batch[0].mel is not None:
            out["mel"] = np.stack([s.mel for s in batch])
        return out
