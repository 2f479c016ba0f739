"""Feature providers: per-utterance audio, spectrogram, mel, energy, pitch
and text (counterpart of ``isp_tts_tpu/data/providers.py``).

The audio providers compute on the host (CPU tensors), as the JAX package's
providers pin their ops to its CPU backend; the batched front end
(:mod:`..ops.frontend`) is the on-device path. Precomputed ``.npy``
features are read where a path is given instead of audio.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops.audio import (frame_energy, log_mel_spectrogram, mel_filterbank, num_frames,
                         stft_magnitude)
from ..ops.pitch import yin_pitch
from .audio import load_audio, load_audio_batch
from .text.processor import TextProcessor
from .text.table import CodingTable


def _maybe_load(source):
    """A precomputed feature when ``source`` names a ``.npy`` file."""
    if isinstance(source, (str, Path)) and str(source).endswith(".npy"):
        return np.load(str(source))
    return None


def _host(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


@dataclass
class AudioProviderConfig:
    sample_rate: int = 22050


class AudioProvider:
    Config = AudioProviderConfig

    def __init__(self, config: AudioProviderConfig | None = None, **kw):
        self.config = config or AudioProviderConfig(**kw)

    def __call__(self, path: str | Path) -> np.ndarray:
        return load_audio(path, self.config.sample_rate)

    def load_batch(self, paths) -> list[np.ndarray]:
        return load_audio_batch(paths, self.config.sample_rate)


@dataclass
class SpectrogramProviderConfig:
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    pad: int | None = None
    power: float = 1.0
    center: bool = False


class SpectrogramProvider:
    Config = SpectrogramProviderConfig

    def __init__(self, config: SpectrogramProviderConfig | None = None, **kw):
        self.config = config or SpectrogramProviderConfig(**kw)

    def num_frames(self, n_samples: int) -> int:
        c = self.config
        return num_frames(n_samples, c.n_fft, c.hop_length, c.pad)

    def __call__(self, source) -> np.ndarray:
        pre = _maybe_load(source)
        if pre is not None:
            return pre
        c = self.config
        return stft_magnitude(_host(source), c.n_fft, c.hop_length, c.win_length,
                              c.pad).numpy()  # (n_freqs, frames)


@dataclass
class MelScaleProviderConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = 8000.0
    norm: str | None = "slaney"
    mel_scale: str = "slaney"


class MelScaleProvider:
    Config = MelScaleProviderConfig

    def __init__(self, config: MelScaleProviderConfig | None = None, **kw):
        self.config = config or MelScaleProviderConfig(**kw)

    @property
    def filterbank(self) -> np.ndarray:
        c = self.config
        return mel_filterbank(c.sample_rate, c.n_fft, c.n_mels, c.f_min, c.f_max, c.norm)

    def __call__(self, source) -> np.ndarray:
        pre = _maybe_load(source)
        if pre is not None:
            return pre
        mel = self.filterbank @ np.asarray(source)  # (n_mels, frames)
        return np.log(np.clip(mel, 1e-5, None))


@dataclass
class MelSpecProviderConfig(MelScaleProviderConfig):
    hop_length: int = 256
    win_length: int = 1024


class MelSpecProvider:
    """Audio -> log-mel in one call."""

    Config = MelSpecProviderConfig

    def __init__(self, config: MelSpecProviderConfig | None = None, **kw):
        self.config = config or MelSpecProviderConfig(**kw)

    def __call__(self, audio) -> np.ndarray:
        c = self.config
        return log_mel_spectrogram(_host(audio), c.sample_rate, c.n_fft, c.hop_length,
                                   c.win_length, c.n_mels, c.f_min, c.f_max).numpy()


class EnergyProvider:
    """Per-frame log1p L2 norm of the linear spectrogram."""

    def __call__(self, source) -> np.ndarray:
        pre = _maybe_load(source)
        if pre is not None:
            return pre
        return frame_energy(_host(source)).numpy()


@dataclass
class PitchProviderConfig:
    sample_rate: int = 22050
    hop_length: int = 256
    win_length: int = 1024
    f_min: int = 40
    f_max: int = 800
    method: str = "yin"
    pad: int | None = None
    threshold: float = 0.15
    norm: str = "standard"
    center: bool = False


class PitchProvider:
    Config = PitchProviderConfig

    def __init__(self, config: PitchProviderConfig | None = None, **kw):
        self.config = c = config or PitchProviderConfig(**kw)
        if c.method in ("yin", "torch-yin"):
            # f_min tied to the window so the YIN frame count tracks the mel's
            self.f_min = 2 * int(c.sample_rate / c.win_length)
        else:
            self.f_min = c.f_min
        self.pad = c.pad if c.pad is not None else (c.win_length - c.hop_length) // 2

    def __call__(self, source, mean: float = 0.0, std: float = 1.0) -> np.ndarray:
        pre = _maybe_load(source)
        c = self.config
        if pre is not None:
            pitch = pre
        elif c.method in ("yin", "torch-yin"):
            audio = np.pad(np.asarray(source), (self.pad, self.pad))
            pitch = yin_pitch(_host(audio), c.sample_rate, self.f_min, c.f_max,
                              c.hop_length, c.threshold).numpy()
        elif c.method == "penn":
            raise ImportError("pitch method 'penn' needs the `penn` package; "
                              "use method 'yin'")
        else:
            raise ValueError(f"unknown pitch method {c.method!r}")
        if c.norm == "log":
            return np.log1p(np.maximum(pitch, 0.0))
        return (pitch - mean) / std


@dataclass
class TextProviderConfig:
    charset: list = None  # type: ignore
    phonemizer: bool = False
    language: str = "en-us"
    mask_phonemes: float | bool = False  # acts on phonemes only
    word_level_prob: bool = True


class TextProvider:
    """Token ids from a coding table, or from a checkpoint's
    ``encoding_map``. With ``phonemizer`` the text goes through espeak-ng
    (or the injected ``phonemizer_backend``); ``mask_phonemes`` keeps that
    share of word groups as graphemes, per word (``word_level_prob``) or,
    otherwise, for the whole utterance with that probability, drawn from
    Python's ``random`` (or ``rng``) as the JAX package draws."""

    def __init__(self, coding_table: CodingTable | dict, phonemizer: bool = False,
                 cleaners: list | None = None, language: str = "en-us",
                 mask_phonemes: float | bool = False, word_level_prob: bool = True,
                 phonemizer_backend=None):
        self.text_processor = TextProcessor(cleaners, language=language, phonemizer=phonemizer,
                                            phonemizer_backend=phonemizer_backend)
        self.coding_table = (coding_table if isinstance(coding_table, CodingTable)
                             else CodingTable.from_encoding_map(coding_table))
        self.mask_phonemes = mask_phonemes
        self.word_level_prob = word_level_prob

    @classmethod
    def from_config(cls, config: TextProviderConfig, phonemizer_backend=None) -> "TextProvider":
        if config.charset is None:
            raise ValueError("TextProvider requires a charset")
        return cls(CodingTable.from_charset(config.charset), phonemizer=config.phonemizer,
                   language=config.language, mask_phonemes=config.mask_phonemes,
                   word_level_prob=config.word_level_prob,
                   phonemizer_backend=phonemizer_backend)

    def __call__(self, text: str, rng: random.Random | None = None) -> np.ndarray:
        """int32 token ids of ``text``, end-of-sentence token included."""
        mask = self.mask_phonemes
        if mask and not self.word_level_prob:
            r = rng.random() if rng is not None else random.random()
            mask = r < float(mask)
        processed = self.coding_table.check_eos(self.text_processor(text, mask_phonemes=mask))
        return np.asarray(self.coding_table.text_to_vector(processed), np.int32)
