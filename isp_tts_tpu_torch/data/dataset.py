"""Acoustic dataset: a meta file and providers -> per-utterance features.

Counterpart of ``isp_tts_tpu/data/dataset.py``: the meta file with text and
audio length filters, pitch/energy statistics from a dict or a JSON path,
per-utterance text, mel, pitch, energy and speaker, an LRU
:class:`FeatureCache` bounded in items and bytes, and ``compute_stats``
(IQR outlier removal, running scaler, ``stats.json``). With
``batched_frontend`` the features of a batch's uncached utterances come
from one :func:`~isp_tts_tpu_torch.ops.frontend.extract_features` pass on
the dataset's device (the card unless the caller names another, or the
config's ``frontend_device`` says ``cpu``); the features then live on the
host, as there, until the trainer moves a collated batch to its device.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..config.registry import build_config
from ..utils.device import resolve_device
from . import providers as dp
from .metadata import TTSMeta
from .stats import DatasetStats, FeatureStats, RunningScaler, remove_outliers

logger = logging.getLogger("isp_tts_tpu_torch")


@dataclass
class AcousticSample:
    filename: str
    text: str
    text_vector: np.ndarray
    text_vector_len: int
    mel: np.ndarray  # (frames, n_mels) channel-last
    mel_len: int
    pitch: np.ndarray | None = None
    energy: np.ndarray | None = None
    speaker: int | None = None


@dataclass
class AcousticDatasetConfig:
    root: str = None  # type: ignore
    meta_name: str = "meta.csv"
    meta_column_names: tuple = ("audio_path", "text")
    text: dict = None  # type: ignore
    audio: dict = None  # type: ignore
    spec: dict = None  # type: ignore
    mel_scale: dict = None  # type: ignore
    pitch: dict | None = None
    energy: dict | None = None
    speaker: str | dict | None = None
    text_length_limits: tuple | None = None
    audio_length_limits: tuple | None = None
    pitch_from_disk: bool = False
    stats: dict | str | None = None
    cache_features: bool = True
    cache_max_items: int | None = None
    cache_max_bytes: float | None = 2 * 1024 ** 3
    batched_frontend: bool = False
    #: where the batched front end runs: None or "default" on the dataset's
    #: device, "cpu" on the host
    frontend_device: str | None = None
    frontend_bucket_multiple: int = 16384


class FeatureCache:
    """Insertion-ordered feature cache with item and byte caps (LRU)."""

    def __init__(self, max_items: int | None = None, max_bytes: float | None = None):
        self.max_items = max_items
        self.max_bytes = max_bytes
        self._data: OrderedDict[int, AcousticSample] = OrderedDict()
        self._bytes = 0

    @staticmethod
    def _nbytes(sample: AcousticSample) -> int:
        return sum(arr.nbytes for arr in (sample.mel, sample.pitch, sample.energy,
                                          sample.text_vector)
                   if arr is not None and hasattr(arr, "nbytes"))

    def __contains__(self, idx: int) -> bool:
        return idx in self._data

    def __len__(self) -> int:
        return len(self._data)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, idx: int) -> AcousticSample:
        self._data.move_to_end(idx)
        return self._data[idx]

    def put(self, idx: int, sample: AcousticSample) -> None:
        if idx in self._data:
            self._bytes -= self._nbytes(self._data.pop(idx))
        self._data[idx] = sample
        self._bytes += self._nbytes(sample)
        while self._data and (
                (self.max_items is not None and len(self._data) > self.max_items)
                or (self.max_bytes is not None and self._bytes > self.max_bytes)):
            _, evicted = self._data.popitem(last=False)
            self._bytes -= self._nbytes(evicted)

    def clear(self) -> None:
        self._data.clear()
        self._bytes = 0


class AcousticDataset:
    Config = AcousticDatasetConfig

    def __init__(self, config: AcousticDatasetConfig,
                 device: str | torch.device | None = None):
        cfg = config
        self.config = cfg
        if cfg.root is None:
            raise ValueError("dataset root is required")
        self.data_root = cfg.root
        self.device = resolve_device(device)

        meta = TTSMeta.load(os.path.join(cfg.root, cfg.meta_name),
                            tuple(cfg.meta_column_names))
        if cfg.text_length_limits is not None:
            meta = meta.filter_length(*list(cfg.text_length_limits))
        if cfg.audio_length_limits is not None:
            meta = meta.filter_audio_length(cfg.root, *list(cfg.audio_length_limits))
        self.meta = meta

        self.text_provider = dp.TextProvider.from_config(
            build_config(dp.TextProviderConfig, cfg.text or {}))
        self.audio_provider = dp.AudioProvider(
            build_config(dp.AudioProviderConfig, cfg.audio or {}))
        self.spec_provider = dp.SpectrogramProvider(
            build_config(dp.SpectrogramProviderConfig, cfg.spec or {}))
        self.mel_scale_provider = dp.MelScaleProvider(
            build_config(dp.MelScaleProviderConfig, cfg.mel_scale or {}))
        self.pitch_provider = (dp.PitchProvider(build_config(dp.PitchProviderConfig, cfg.pitch))
                               if cfg.pitch is not None else None)
        self.energy_provider = dp.EnergyProvider() if cfg.energy is not None else None

        speaker = cfg.speaker
        if isinstance(speaker, str):
            with open(speaker, encoding="utf-8") as f:
                speaker = json.load(f)
        self.speaker_map = dict(speaker) if speaker is not None else None

        stats = cfg.stats
        if stats is None:
            self.stats = DatasetStats()
        elif isinstance(stats, DatasetStats):
            self.stats = stats
        elif isinstance(stats, dict):
            self.stats = DatasetStats.from_dict(stats)
        else:
            self.stats = DatasetStats.load(stats)

        self._cache = (FeatureCache(cfg.cache_max_items, cfg.cache_max_bytes)
                       if cfg.cache_features else None)
        self._frontend_cfg = self._make_frontend_config() if cfg.batched_frontend else None
        self.frontend_device = (torch.device("cpu") if cfg.frontend_device == "cpu"
                                else self.device)
        #: seconds spent in batched front-end passes, and their count
        self.frontend_seconds = 0.0
        self.frontend_calls = 0

    def _make_frontend_config(self):
        """The providers' settings as a FrontendConfig, or None (per-utterance
        providers) where the batched pass does not compute the same thing."""
        from ..ops.frontend import FrontendConfig

        cfg = self.config
        if cfg.pitch_from_disk:
            logger.warning("batched_frontend ignores pitch_from_disk; "
                           "using per-utterance providers")
            return None
        if self.pitch_provider is not None and (
                self.pitch_provider.config.method not in ("yin", "torch-yin")
                or self.pitch_provider.config.norm != "standard"):
            logger.warning("batched_frontend supports yin pitch with standard "
                           "norm only; using per-utterance providers")
            return None
        pitch_cfg = self.pitch_provider.config if self.pitch_provider else None
        return FrontendConfig(
            sample_rate=self.audio_provider.config.sample_rate,
            n_fft=self.spec_provider.config.n_fft,
            hop_length=self.spec_provider.config.hop_length,
            win_length=self.spec_provider.config.win_length,
            n_mels=self.mel_scale_provider.config.n_mels,
            f_min=self.mel_scale_provider.config.f_min,
            f_max=self.mel_scale_provider.config.f_max,
            pitch_f_max=float(pitch_cfg.f_max) if pitch_cfg else 800.0,
            pitch_threshold=pitch_cfg.threshold if pitch_cfg else 0.15,
        )

    def __len__(self) -> int:
        return len(self.meta)

    def _with_fresh_text(self, cached: AcousticSample) -> AcousticSample:
        vector = self.text_provider(cached.text)
        return AcousticSample(**{**cached.__dict__, "text_vector": vector,
                                 "text_vector_len": len(vector)})

    def _speaker(self, record) -> int | None:
        return int(self.speaker_map[record.speaker]) if self.speaker_map is not None else None

    def __getitem__(self, idx: int) -> AcousticSample:
        if self._cache is not None and idx in self._cache:
            return self._with_fresh_text(self._cache.get(idx))
        record = self.meta[idx]
        vector = self.text_provider(record.text)
        audio = self.audio_provider(Path(self.data_root, record.audio_path))
        spec = self.spec_provider(audio)
        mel = self.mel_scale_provider(spec).T  # (frames, n_mels)
        mel_len = mel.shape[0]
        pitch = None
        if self.pitch_provider is not None:
            source = (Path(self.data_root, record.pitch) if self.config.pitch_from_disk
                      else audio)
            pitch = self.pitch_provider(source, self.stats.pitch.mean, self.stats.pitch.std)
            pitch = np.pad(pitch, (0, max(mel_len - len(pitch), 0)))[:mel_len]
        energy = self.energy_provider(spec)[:mel_len] if self.energy_provider else None
        sample = AcousticSample(
            filename=record.audio_path, text=record.text, text_vector=vector,
            text_vector_len=len(vector), mel=mel.astype(np.float32), mel_len=mel_len,
            pitch=pitch.astype(np.float32) if pitch is not None else None,
            energy=energy.astype(np.float32) if energy is not None else None,
            speaker=self._speaker(record))
        if self._cache is not None:
            self._cache.put(idx, sample)
        return sample

    def get_batch(self, indices: list[int]) -> list[AcousticSample]:
        """The samples of ``indices``; with ``batched_frontend`` the uncached
        ones come from one front-end pass."""
        if self._frontend_cfg is None:
            return [self[i] for i in indices]
        missing = [i for i in indices if self._cache is None or i not in self._cache]
        fresh = self._extract_batch(missing) if missing else {}
        out = []
        for i in indices:
            if i in fresh:
                out.append(fresh[i])
            elif self._cache is not None and i in self._cache:
                out.append(self._with_fresh_text(self._cache.get(i)))
            else:
                out.append(self[i])
        return out

    def _extract_batch(self, indices: list[int]) -> dict[int, AcousticSample]:
        import time

        from ..ops.frontend import bucket_audio, extract_features

        records = [self.meta[i] for i in indices]
        audios = self.audio_provider.load_batch(
            [Path(self.data_root, r.audio_path) for r in records])
        padded, lens = bucket_audio(audios, self.config.frontend_bucket_multiple)
        dev = self.frontend_device
        t0 = time.perf_counter()
        feats = extract_features(torch.from_numpy(padded).to(dev),
                                 torch.from_numpy(lens).to(dev), self._frontend_cfg,
                                 pitch_mean=self.stats.pitch.mean,
                                 pitch_std=self.stats.pitch.std)
        mel, pitch, energy, mel_lens = (x.cpu().numpy() for x in feats)
        self.frontend_seconds += time.perf_counter() - t0
        self.frontend_calls += 1
        out: dict[int, AcousticSample] = {}
        for j, (idx, record) in enumerate(zip(indices, records)):
            n = int(mel_lens[j])
            vector = self.text_provider(record.text)
            sample = AcousticSample(
                filename=record.audio_path, text=record.text, text_vector=vector,
                text_vector_len=len(vector), mel=mel[j, :n].astype(np.float32), mel_len=n,
                pitch=(pitch[j, :n].astype(np.float32)
                       if self.pitch_provider is not None else None),
                energy=(energy[j, :n].astype(np.float32)
                        if self.energy_provider is not None else None),
                speaker=self._speaker(record))
            out[idx] = sample
            if self._cache is not None:
                self._cache.put(idx, sample)
        return out

    def compute_stats(self, save_stats: bool = True, save_path: str | None = None,
                      batch_size: int = 64) -> DatasetStats:
        """Pitch and energy statistics of the unnormalised features, with IQR
        outlier removal; in ``batch_size`` front-end passes when batched.
        The feature cache is bypassed during the scan and cleared after."""
        self.stats = DatasetStats()  # identity normalisation during the scan
        cache, self._cache = self._cache, None
        try:
            return self._compute_stats_scan(cache, batch_size, save_stats, save_path)
        finally:
            self._cache = cache

    def _compute_stats_scan(self, cache, batch_size, save_stats, save_path):
        def scan_samples():
            if self._frontend_cfg is not None:
                n = len(self)
                for s0 in range(0, n, batch_size):
                    idxs = list(range(s0, min(s0 + batch_size, n)))
                    batch = self._extract_batch(idxs)
                    yield from (batch[i] for i in idxs)
            else:
                yield from (self[i] for i in range(len(self)))

        p_scaler, e_scaler = RunningScaler(), RunningScaler()
        p_min = e_min = np.finfo(np.float64).max
        p_max = e_max = np.finfo(np.float64).min
        for sample in scan_samples():
            if sample.pitch is not None:
                pitch = remove_outliers(sample.pitch)
                pitch = pitch[pitch > 0.0]
                if len(pitch):
                    p_scaler.update(pitch.reshape(-1, 1))
                    p_min, p_max = min(p_min, pitch.min()), max(p_max, pitch.max())
            if sample.energy is not None:
                energy = remove_outliers(sample.energy)
                if len(energy):
                    e_scaler.update(energy.reshape(-1, 1))
                    e_min, e_max = min(e_min, energy.min()), max(e_max, energy.max())

        def stats(scaler, lo, hi):
            return FeatureStats(
                min=float(lo), max=float(hi),
                mean=float(scaler.mean[0]) if scaler.mean is not None else 0.0,
                std=float(scaler.std[0]) if scaler.std is not None else 1.0)

        self.stats = DatasetStats(pitch=stats(p_scaler, p_min, p_max),
                                  energy=stats(e_scaler, e_min, e_max))
        if cache is not None:
            cache.clear()  # entries normalised with the superseded stats
        if save_stats:
            path = save_path or os.path.join(self.data_root, "stats.json")
            self.stats.save(path)
            logger.info("saved dataset stats to %s", path)
        return self.stats
