"""Experiment factory: a recipe -> dataset, collator, model, loss,
evaluator and trainer (counterpart of ``isp_tts_tpu/training/experiment.py``).

Builders are keyed by ``_name_`` against the registries; a dataset's
``_train_`` / ``_eval_`` sections override its config for that split;
``inject_data_config`` writes the dataset's symbol table and statistics
into the model config before the model is built. Everything is built for
one device (the card unless the caller names another), and the resolved
recipe is saved beside the checkpoints as ``config.yaml``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..config import build_config, load_recipe, merge_dicts, strip_meta
from ..config.yamlio import dump
from ..data import COLLATORS, DATASETS
from ..models import CRITERIA, EVALUATORS, MODELS
from ..utils.device import resolve_device
from .gan_trainer import GANTrainer
from .trainer import Trainer
from .trainer_config import TrainerConfig


class ExperimentModules:
    def __init__(self, config_name: str, config_root: str = "recipes",
                 overrides: dict | None = None, device: str | torch.device | None = None):
        self.config = load_recipe(config_name, config_root, overrides=overrides)
        self.config_name = config_name
        self.device = resolve_device(device)
        self.train_dataset = None
        self.eval_dataset = None
        self.collator = None
        self.model = None
        self.criterion = None
        self.evaluator = None

    def build_dataset(self, split: str):
        cfg = self.config.get("dataset")
        if cfg is None:
            return None
        cfg = dict(cfg)
        for key in ("_train_", "_eval_"):
            override = cfg.pop(key, None)
            if key == f"_{split}_" and override:
                cfg = merge_dicts(cfg, override)
        cls = DATASETS.get(cfg.get("_name_", "AcousticDataset"))
        return cls(build_config(cls.Config, cfg), device=self.device)

    def build_collator(self):
        cfg = dict(self.config.get("collator") or {"_name_": "AcousticCollator"})
        cls = COLLATORS.get(cfg.get("_name_", "AcousticCollator"))
        return cls(build_config(cls.Config, cfg))

    def build_model(self, dataset, seed: int = 0):
        cfg = dict(self.config["model"])
        cls = MODELS.get(cfg.get("_name_", "AcousticModel"))
        if dataset is not None:
            cfg = cls.inject_data_config(cfg, dataset)
        # the initial weights from ``seed``; torch's default generators are
        # left as they were
        with torch.random.fork_rng(devices=[]):  # the model is built on the host
            torch.random.default_generator.manual_seed(seed)
            return cls(build_config(cls.Config, cfg))

    def build_criterion(self):
        cfg = dict(self.config.get("criterion") or {"_name_": "AcousticModelLoss"})
        cls = CRITERIA.get(cfg.get("_name_", "AcousticModelLoss"))
        return cls(build_config(cls.Config, cfg))

    def build_evaluator(self, model):
        cfg = self.config.get("evaluator")
        if cfg is None:
            return None
        cls = EVALUATORS.get(cfg.get("_name_", "AcousticModelEvaluator"))
        return cls(model, **strip_meta(cfg))

    def build_trainer_config(self) -> TrainerConfig:
        return build_config(TrainerConfig, dict(self.config.get("trainer") or {}))

    def init_modules(self) -> "ExperimentModules":
        trainer_cfg = self.build_trainer_config()
        self.train_dataset = self.build_dataset("train")
        self.eval_dataset = self.build_dataset("eval")
        self.collator = self.build_collator()
        self.model = self.build_model(self.train_dataset or self.eval_dataset,
                                      seed=trainer_cfg.seed)
        self.criterion = self.build_criterion()
        self.evaluator = self.build_evaluator(self.model)
        return self

    def build_trainer(self, **kwargs) -> Trainer:
        """The trainer over the built modules (``kwargs`` go to it, e.g. a
        ``generator``): the GANTrainer for a model whose ``TRAINER`` is
        "gan", else the Trainer; writes the resolved recipe as
        ``config.yaml``."""
        if self.model is None:
            self.init_modules()
        cls = GANTrainer if getattr(self.model, "TRAINER", None) == "gan" else Trainer
        trainer = cls(model=self.model, criterion=self.criterion,
                          config=self.build_trainer_config(),
                          train_dataset=self.train_dataset, eval_dataset=self.eval_dataset,
                          collator=self.collator, evaluator=self.evaluator,
                          experiment_config=self.config, device=self.device, **kwargs)
        run_dir = Path(trainer.run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.yaml").write_text(dump(self.config), encoding="utf-8")
        return trainer
