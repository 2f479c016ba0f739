"""Trainer configuration (counterpart of
``isp_tts_tpu/training/trainer_config.py``: it takes every key there).

``precision`` is the compute dtype under autocast over float32 master
weights: bf16, fp16 (no loss scaling, as in the JAX package) or fp32 (full
float32 on the card: the trainer's steps run with TF32 off).
The data axis spans the ranks the other axes leave: ``mesh_model_axis``
splits heads and feed-forward dims over that many ranks,
``mesh_seq_axis`` rings ``flash: ring`` attention over that many, and
``mesh_pipeline_axis`` cuts ``pipeline: true`` layer stacks into that many
stages, streaming ``pipeline_microbatches`` microbatches through them. Each
above 1 needs a process group (``--distributed``); ``num_devices`` caps the
ranks. A model axis beside a pipeline axis splits each stage's stacked
layers over the model ranks. The JAX settings with no counterpart (``IGNORED_KEYS``) are
accepted and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import ClassVar

from .optimizers import OptimizationConfig

#: precision names the trainer computes
PRECISIONS = ("bf16", "bfloat16", "fp16", "float16", "fp32", "float32")


@dataclass
class TrainerConfig:
    #: JAX settings of its PRNG and compiler: the 'rbg' PRNG switch and
    #: XLA's compilation cache
    IGNORED_KEYS: ClassVar[frozenset] = frozenset({"fast_rng", "compilation_cache"})

    # what to run
    do_train: bool = True
    do_eval: bool = True

    # reproducibility / numerics
    seed: int = 42
    precision: str = "bf16"

    # output / logging
    output_dir: str = "results"
    experiment_name: str = "experiment"
    label: str | None = None
    log_with: tuple = ("tensorboard",)
    logging_strategy: str = "steps"  # no | steps | epoch
    logging_steps: int = 10
    progress: bool = True
    disable_tqdm: bool = False

    # data
    shuffle: bool = True
    drop_last: bool = True

    # schedule
    epochs: int = 100
    max_steps: int | None = None
    batch_size: int = 32
    eval_batch_size: int | None = None

    # evaluation
    eval_strategy: str = "steps"  # no | steps | epoch
    eval_steps: int = 50
    eval_first_step: bool = False
    eval_batches: int | None = None
    #: an evaluation-only run: ``train()`` runs one evaluation pass
    eval_mode: bool = False

    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)

    # checkpointing
    save_strategy: str = "steps"  # no | steps | epoch
    save_steps: int = 50
    save_optimizer: bool = True
    save_best_only: bool = False
    save_rewrite_checkpoint: bool = False
    metric_for_best_model: str | None = "loss"
    metric_maximize: bool = False

    # resume / warm start / fine-tuning
    resume_from_checkpoint: str | None = None
    warm_start: bool = False
    ignore_layers: tuple = ()
    ignore_mismatched_keys: bool = True
    finetune_layers: tuple | None = None  # None or [] trains all; else prefixes
    restore_optimizer: bool = False
    restore_lr: bool = True

    # callbacks: {name: {kwargs}} added to the defaults
    callbacks: dict = field(default_factory=dict)

    # mesh: data × model × seq × stage over the process group's ranks
    mesh_model_axis: int = 1
    mesh_seq_axis: int = 1
    mesh_pipeline_axis: int = 1
    #: microbatches a stacked layer stack streams per step
    pipeline_microbatches: int = 4
    #: at most this many ranks (None: every rank of the process group)
    num_devices: int | None = None

    # observability
    profile_steps: tuple | None = None  # (start_step, end_step): torch.profiler trace
    debug_nans: bool = False  # torch.autograd anomaly detection

    #: steps run back to back per chunk, then their log/eval/save flags
    #: replayed per step (a mid-chunk eval or save sees the post-chunk
    #: weights); needs fixed-shape collation
    steps_per_call: int = 1

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; one of {PRECISIONS}")
        for axis in ("mesh_model_axis", "mesh_seq_axis", "mesh_pipeline_axis",
                     "pipeline_microbatches"):
            if int(getattr(self, axis)) < 1:
                raise ValueError(f"{axis} must be >= 1")
        if int(self.steps_per_call) < 1:
            raise ValueError("steps_per_call must be >= 1")
        self.do_train = self.do_train and not self.eval_mode
        if self.eval_batch_size is None:
            self.eval_batch_size = self.batch_size
        parts = [p for p in (self.experiment_name, self.label) if p]
        self.run_dir = str(Path(self.output_dir, *parts))
