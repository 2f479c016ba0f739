"""The trainer core: one training step, an evaluation step, a step loop.

Counterpart of the hot step of ``isp_tts_tpu/training/trainer.py``
(``Trainer._build_steps``: forward, loss, gradient, global norm, optimizer
update) and of its per-step LR schedule. With ``precision`` bf16 the
forward runs under ``torch.autocast`` in bfloat16 (matrix products and
attention in bf16; norms, softmaxes and losses in f32) over f32 master
weights, as the JAX policy does. Dropout and the flow predictor's noise
draw from one ``torch.Generator`` on the device. Checkpoint save and
resume, gradient accumulation, freeze masks, chunked steps, callbacks and
profiling are not ported yet.
"""

from __future__ import annotations

import torch

from ..nn.layers import set_dropout_generator
from ..utils.device import resolve_device
from .optimizers import build_optimizer, clip_grad_norm, global_grad_norm, set_learning_rate
from .trainer_config import TrainerConfig


class Trainer:
    def __init__(self, model: torch.nn.Module, criterion, config: TrainerConfig,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.criterion = criterion
        self.config = config
        self.generator = generator or torch.Generator(device=self.device).manual_seed(
            config.seed)
        set_dropout_generator(self.model, self.generator)
        self.optimizer, self.schedule = build_optimizer(config.optimization, self.model)
        self.global_step = 0

    def _forward(self, batch: dict, noise=None, t=None):
        inputs = self.model.prepare_inputs(
            {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
             for k, v in batch.items()})
        bf16 = self.config.precision in ("bf16", "bfloat16")
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bf16):
            outputs = self.model(**inputs, noise=noise, t=t, generator=self.generator)
        loss, losses = self.criterion(inputs, outputs, self.global_step)
        return loss, losses, outputs

    def compute_gradients(self, batch: dict, noise=None, t=None):
        """Forward, loss and backward on ``batch`` (a collated dict), then
        the clip; ``noise``/``t`` fix the flow predictor's draws. Returns
        (loss, loss dict, gradient norm before the clip); the clipped
        gradients are left in ``.grad``."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, losses, _ = self._forward(batch, noise, t)
        loss.backward()
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:  # optax decays and steps every parameter
                p.grad = torch.zeros_like(p)
        clip = self.config.optimization.grad_clip_norm
        norm = clip_grad_norm(params, clip) if clip else global_grad_norm(params)
        return loss.detach(), {k: v.detach() for k, v in losses.items()}, norm

    def train_step(self, batch: dict, noise=None, t=None) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``. Returns the JAX trainer's metric
        names as 0-dim tensors on the device."""
        loss, losses, norm = self.compute_gradients(batch, noise, t)
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss, **losses, "stats/grad_norm": norm}

    @torch.no_grad()
    def eval_step(self, batch: dict, noise=None, t=None):
        """(model outputs, metrics) in eval mode: no dropout, no update."""
        self.model.eval()
        loss, losses, outputs = self._forward(batch, noise, t)
        return outputs, {"loss": loss, **losses}

    def train(self, batches: list[dict], steps: int) -> list[dict[str, float]]:
        """``steps`` optimizer steps cycling over ``batches`` (one pass is an
        epoch); the schedule sets each step's LR first. Returns each step's
        metrics as floats, with ``stats/learning_rate``."""
        history = []
        for _ in range(steps):
            batch = batches[self.global_step % len(batches)]
            lr = self.schedule(self.global_step, self.global_step // len(batches))
            set_learning_rate(self.optimizer, lr)
            metrics = {k: float(v) for k, v in self.train_step(batch).items()}
            metrics["stats/learning_rate"] = lr
            history.append(metrics)
        return history
