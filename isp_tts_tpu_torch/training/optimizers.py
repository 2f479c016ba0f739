"""Optimizer, gradient clipping and LR schedules.

Counterpart of ``isp_tts_tpu/training/optimizers.py``: the optax chain
clip_by_global_norm -> scale_by_adam -> add_decayed_weights (tensors with
ndim >= 2 only) -> scale by -lr is ``torch.optim.AdamW`` with two parameter
groups (weight decay on the ndim >= 2 tensors, none on the rest) after
:func:`clip_grad_norm`, which clips as optax does: g * max / ||g|| when
||g|| > max, no epsilon. :class:`Schedule` is the host-side LR schedule
with its four schedulers. Gradient accumulation and freeze masks are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class LRSchedulerConfig:
    _target_: str = "none"
    gamma: float = 1.0  # exponential decay rate
    step_size: int = 1  # steps per decay (exponential-step)
    warmup_steps: int = 1000  # warmup
    scale: float = 1.0  # warmup peak scale
    anneal_steps: tuple = ()  # warmup anneal milestones
    anneal_rate: float = 0.3


@dataclass
class OptimizationConfig:
    _target_: str = "adamw"
    learning_rate: float = 2e-4
    weight_decay: float = 1e-2
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float | None = 1.0
    grad_accum_steps: int = 1
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)


class Schedule:
    """Host-side LR schedule: lr(step, epoch) -> float. "exponential"
    decays per epoch, the others per optimizer step."""

    def __init__(self, cfg: LRSchedulerConfig, base_lr: float):
        self.cfg = cfg
        self.base_lr = base_lr
        self.kind = cfg._target_ or "none"

    def __call__(self, step: int, epoch: int) -> float:
        c = self.cfg
        if self.kind == "none":
            return self.base_lr
        if self.kind == "exponential":
            return self.base_lr * (c.gamma ** epoch)
        if self.kind == "exponential-step":
            return self.base_lr * (c.gamma ** (step // max(c.step_size, 1)))
        if self.kind == "warmup":
            s = max(step, 1)
            lr = c.scale * self.base_lr * min(s ** -0.5, s * c.warmup_steps ** -1.5) \
                * (c.warmup_steps ** 0.5)
            for milestone in c.anneal_steps:
                if s > milestone:
                    lr = lr * c.anneal_rate
            return lr
        raise KeyError(f"Unknown lr scheduler {self.kind!r}")


def build_optimizer(config: OptimizationConfig, model: torch.nn.Module):
    """(AdamW over ``model``'s parameters, its Schedule)."""
    cfg = config
    if cfg._target_ != "adamw":
        raise NotImplementedError(f"optimizer {cfg._target_!r} is not ported")
    if cfg.grad_accum_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": [p for p in params if p.dim() >= 2],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p in params if p.dim() < 2], "weight_decay": 0.0}]
    opt = torch.optim.AdamW(groups, lr=cfg.learning_rate, betas=tuple(cfg.betas),
                            eps=cfg.eps)
    return opt, Schedule(cfg.lr_scheduler, cfg.learning_rate)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def global_grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the gradients (as optax.global_norm); NaN when any
    gradient is not finite, so the trainer can flag it."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    return torch.where(torch.isfinite(norm), norm, torch.full_like(norm, float("nan")))


def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| where
    ||g|| > max_norm, untouched otherwise. Returns the norm before."""
    params = [p for p in params if p.grad is not None]
    norm = global_grad_norm(params)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        p.grad.mul_(factor.to(p.grad.dtype))
    return norm
