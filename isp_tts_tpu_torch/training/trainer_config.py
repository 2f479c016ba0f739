"""Trainer configuration: the part of ``isp_tts_tpu/training/trainer_config.py``
that the port's trainer computes. A checkpoint's full
``experiment.config.trainer`` rebuilds it: its other keys are either in
``IGNORED_KEYS`` or refused by ``build_config``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

from .optimizers import OptimizationConfig

#: precision names the trainer computes: bf16 autocast, or float32
PRECISIONS = ("bf16", "bfloat16", "fp32", "float32")


@dataclass
class TrainerConfig:
    #: keys of the JAX TrainerConfig that cannot change what one step
    #: computes: run control, logging, evaluation and checkpoint saving,
    #: the data order (the caller hands ``Trainer.train`` its batches),
    #: chunked dispatch (``steps_per_call``: the same steps, fewer host
    #: calls), the PRNG implementation and compilation settings
    IGNORED_KEYS: ClassVar[frozenset] = frozenset({
        "do_train", "do_eval", "output_dir", "experiment_name", "label", "log_with",
        "logging_strategy", "logging_steps", "progress", "disable_tqdm", "shuffle",
        "drop_last", "epochs", "max_steps", "batch_size", "eval_batch_size",
        "eval_strategy", "eval_steps", "eval_first_step", "eval_batches", "eval_mode",
        "save_strategy", "save_steps", "save_optimizer", "save_best_only",
        "save_rewrite_checkpoint", "metric_for_best_model", "metric_maximize",
        "callbacks", "num_devices", "profile_steps", "debug_nans", "steps_per_call",
        "fast_rng", "compilation_cache"})

    seed: int = 42
    precision: str = "bf16"  # compute dtype: bf16 (autocast) | fp32; weights f32
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    #: parameter-name prefixes to train, the rest frozen; None or [] trains
    #: every parameter (the freeze mask is not ported: any other value raises)
    finetune_layers: tuple | None = None

    def __post_init__(self):
        if self.precision in ("fp16", "float16"):
            raise NotImplementedError("precision fp16 is not ported; use bf16 or fp32")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; one of {PRECISIONS}")
        if self.finetune_layers:
            raise NotImplementedError("finetune_layers (the freeze mask) is not ported")
