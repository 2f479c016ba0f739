"""Trainer configuration: the part of ``isp_tts_tpu/training/trainer_config.py``
that the port's trainer reads. ``build_config`` drops the keys it does not
declare, so a checkpoint's full ``experiment.config.trainer`` rebuilds it."""

from __future__ import annotations

from dataclasses import dataclass, field

from .optimizers import OptimizationConfig


@dataclass
class TrainerConfig:
    seed: int = 42
    precision: str = "bf16"  # compute dtype: bf16 (autocast) | fp32; weights f32
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
