"""Dataset feature statistics: IQR outlier removal and a running mean/std
(counterpart of ``isp_tts_tpu/data/stats.py``)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


def remove_outliers(values: np.ndarray) -> np.ndarray:
    """Drop values outside [p25 - 1.5 IQR, p75 + 1.5 IQR]."""
    values = np.asarray(values)
    p25, p75 = np.quantile(values, 0.25), np.quantile(values, 0.75)
    iqr = p75 - p25
    keep = (values > p25 - 1.5 * iqr) & (values < p75 + 1.5 * iqr)
    return values[keep]


@dataclass
class FeatureStats:
    min: float = float(np.finfo(np.float32).max)
    max: float = float(np.finfo(np.float32).min)
    mean: float = 0.0
    std: float = 1.0

    def to_dict(self) -> dict:
        return {"min": float(self.min), "max": float(self.max),
                "mean": float(self.mean), "std": float(self.std)}

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureStats":
        return cls(**{k: float(v) for k, v in d.items() if k in ("min", "max", "mean", "std")})


class RunningScaler:
    """Count-weighted streaming mean/std (merge of per-chunk moments)."""

    def __init__(self):
        self.mean = None
        self.std = None
        self.count = 0

    def update(self, x: np.ndarray) -> "RunningScaler":
        x = np.asarray(x, dtype=np.float64)
        n, m, v = x.shape[0], x.mean(axis=0), x.var(axis=0)
        if n == 0:
            return self
        if self.mean is None:
            self.mean, self.std, self.count = m, np.sqrt(v), n
            return self
        total = self.count + n
        new_mean = (self.mean * self.count + m * n) / total
        new_var = (
            self.count * (self.std ** 2 + self.mean ** 2) + n * (v + m ** 2)
        ) / total - new_mean ** 2
        self.mean, self.std, self.count = new_mean, np.sqrt(np.maximum(new_var, 0)), total
        return self


@dataclass
class DatasetStats:
    pitch: FeatureStats = field(default_factory=FeatureStats)
    energy: FeatureStats = field(default_factory=FeatureStats)

    def to_dict(self) -> dict:
        return {"pitch": self.pitch.to_dict(), "energy": self.energy.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetStats":
        return cls(
            pitch=FeatureStats.from_dict(d.get("pitch", {})),
            energy=FeatureStats.from_dict(d.get("energy", {})),
        )

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "DatasetStats":
        return cls.from_dict(json.loads(Path(path).read_text()))
