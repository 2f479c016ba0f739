"""Trainer state, control flags and callbacks (counterpart of
``isp_tts_tpu/training/callbacks.py``).

``TrainerState`` (with its JSON sidecar), ``TrainerControl``, the 11-event
``TrainerCallback`` interface and its ``CallbackHandler``; the built-ins
``default_flow`` (raises the log/evaluate/save flags of the strategies and
stops at ``max_steps``), ``progress``, ``printer``, ``epoch_seed``
(reseeds ``random``, numpy and torch with ``(epoch + 1) * seed``) and
``tracker`` (tensorboard through ``torch.utils.tensorboard``, or wandb;
a backend that is not installed is warned about and left out, as there).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..config.registry import Registry

logger = logging.getLogger("isp_tts_tpu_torch")

CALLBACKS = Registry("callbacks")


def set_random_seed(seed: int, torch_generators: bool = True) -> None:
    """Seed ``random`` and numpy, and with ``torch_generators`` torch's
    default generators (every device's) too."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    if torch_generators:
        torch.manual_seed(seed)


class IntervalStrategy:
    NO = "no"
    STEPS = "steps"
    EPOCH = "epoch"


@dataclass
class TrainerState:
    epoch: float = 0.0
    global_step: int = 0
    epoch_step: int = 0
    max_steps: int = 0
    num_train_epochs: int = 0
    best_metric: float | None = None
    best_model_checkpoint: str | None = None
    last_model_checkpoint: str | None = None
    learning_rate: float = 0.0
    is_main_process: bool = True
    log_history: list = field(default_factory=list)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def from_json(cls, path: str | Path) -> "TrainerState":
        data = json.loads(Path(path).read_text())
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


@dataclass
class TrainerControl:
    should_training_stop: bool = False
    should_epoch_stop: bool = False
    should_save: bool = False
    should_evaluate: bool = False
    should_log: bool = False
    is_train: bool = True

    def reset_step(self) -> None:
        self.should_save = False
        self.should_evaluate = False
        self.should_log = False

    def reset_epoch(self) -> None:
        self.should_epoch_stop = False


class TrainerCallback:
    """The 11 events; a handler may mutate and return ``control``."""

    def on_init_end(self, config, state, control, **kw): ...
    def on_train_begin(self, config, state, control, **kw): ...
    def on_train_end(self, config, state, control, **kw): ...
    def on_epoch_begin(self, config, state, control, **kw): ...
    def on_epoch_end(self, config, state, control, **kw): ...
    def on_step_begin(self, config, state, control, **kw): ...
    def on_step_end(self, config, state, control, **kw): ...
    def on_substep_end(self, config, state, control, **kw): ...
    def on_evaluate(self, config, state, control, **kw): ...
    def on_save(self, config, state, control, **kw): ...
    def on_log(self, config, state, control, logs=None, **kw): ...


class CallbackHandler:
    """Fans each ``on_*`` event out to every callback."""

    def __init__(self, callbacks: list[TrainerCallback]):
        self.callbacks = list(callbacks)

    def add(self, callback: TrainerCallback) -> None:
        self.callbacks.append(callback)

    def _event(self, name, config, state, control, **kw):
        for cb in self.callbacks:
            result = getattr(cb, name)(config, state, control, **kw)
            if result is not None:
                control = result
        return control

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda config, state, control, **kw: self._event(
                name, config, state, control, **kw)
        raise AttributeError(name)


@CALLBACKS.register("default_flow")
class DefaultFlowCallback(TrainerCallback):
    def on_step_end(self, config, state, control, **kw):
        if config.logging_strategy == IntervalStrategy.STEPS and \
                config.logging_steps and state.global_step % config.logging_steps == 0:
            control.should_log = True
        if config.eval_strategy == IntervalStrategy.STEPS and \
                config.eval_steps and state.global_step % config.eval_steps == 0:
            control.should_evaluate = True
        if config.save_strategy == IntervalStrategy.STEPS and \
                config.save_steps and state.global_step % config.save_steps == 0:
            control.should_save = True
        if state.max_steps and state.global_step >= state.max_steps:
            control.should_training_stop = True
        return control

    def on_epoch_end(self, config, state, control, **kw):
        if config.logging_strategy == IntervalStrategy.EPOCH:
            control.should_log = True
        if config.eval_strategy == IntervalStrategy.EPOCH:
            control.should_evaluate = True
        if config.save_strategy == IntervalStrategy.EPOCH:
            control.should_save = True
        return control


@CALLBACKS.register("progress")
class ProgressCallback(TrainerCallback):
    """A tqdm bar where tqdm is installed, else one log line per log event."""

    def __init__(self):
        self.bar = None

    def on_train_begin(self, config, state, control, **kw):
        if not (state.is_main_process and config.progress):
            return
        try:
            from tqdm import tqdm
        except ImportError:
            return
        self.bar = tqdm(total=state.max_steps, desc="train", initial=state.global_step,
                        dynamic_ncols=True)

    def on_step_end(self, config, state, control, **kw):
        if self.bar is not None:
            self.bar.update(1)

    def on_log(self, config, state, control, logs=None, **kw):
        if not logs:
            return
        show = {k.split("/")[-1]: f"{v:.4g}" for k, v in logs.items()
                if isinstance(v, (int, float)) and "time" not in k}
        if self.bar is not None:
            self.bar.set_postfix(show, refresh=False)
        elif config.progress:
            logger.info("step %d/%d: %s", state.global_step, state.max_steps, show)

    def on_train_end(self, config, state, control, **kw):
        if self.bar is not None:
            self.bar.close()
            self.bar = None


@CALLBACKS.register("printer")
class PrinterCallback(TrainerCallback):
    def on_log(self, config, state, control, logs=None, **kw):
        if state.is_main_process and logs:
            logger.info("step %d: %s", state.global_step,
                        {k: (round(v, 5) if isinstance(v, float) else v)
                         for k, v in logs.items()})


@CALLBACKS.register("epoch_seed")
class EpochReproducibilityCallback(TrainerCallback):
    def on_epoch_begin(self, config, state, control, **kw):
        set_random_seed((int(state.epoch) + 1) * config.seed)


@CALLBACKS.register("tracker")
class TrackerCallback(TrainerCallback):
    """Scalars (and figures) to tensorboard or wandb."""

    def __init__(self, log_dir: str | None = None):
        self.log_dir = log_dir
        self.writer = None
        self.wandb = None

    def on_train_begin(self, config, state, control, **kw):
        if not state.is_main_process:
            return
        log_with = tuple(config.log_with or ())
        if "tensorboard" in log_with or not log_with:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(self.log_dir or str(Path(config.output_dir) / "tb"))
            except ImportError:
                logger.warning("tensorboard unavailable; tracker disabled")
        if "wandb" in log_with:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=config.experiment_name, dir=str(config.output_dir))
            except ImportError:
                logger.warning("wandb requested but not installed; skipped")

    def on_log(self, config, state, control, logs=None, **kw):
        if not logs:
            return
        scalars = {k: v for k, v in logs.items() if isinstance(v, (int, float))}
        figures = {k: v for k, v in logs.items() if hasattr(v, "canvas")}
        if self.writer is not None:
            for key, value in scalars.items():
                self.writer.add_scalar(key, value, state.global_step)
            if figures:
                from ..utils.plotting import figure_to_array

                for key, fig in figures.items():
                    self.writer.add_image(key, figure_to_array(fig), state.global_step,
                                          dataformats="HWC")
        if self.wandb is not None:
            self.wandb.log(scalars, step=state.global_step)

    def on_train_end(self, config, state, control, **kw):
        if self.writer is not None:
            self.writer.close()
        if self.wandb is not None:
            self.wandb.finish()
