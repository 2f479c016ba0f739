"""GANTrainer: adversarial training of a generator and a discriminator.

Counterpart of ``isp_tts_tpu/training/gan_trainer.py`` for models with a
``.generator`` and a ``.discriminator`` (``VocoderModel``). The epoch loop,
callbacks, strategies, evaluation, checkpoints and resume are the base
:class:`Trainer`'s; the differences are:

- two optimizers, one a branch, each over its own submodule and keyed
  under ``['gen']`` and ``['disc']`` with paths relative to the branch, as
  the JAX trainer's ``opt_state = {"gen", "disc"}`` stores them, so either
  package resumes the other's checkpoint; the learning rate goes to both,
  each branch clips its own gradients, and ``finetune_layers`` is matched
  against the full name (``generator.blocks.3...``) of each branch's
  parameters;
- the step, in HiFi-GAN's order: the discriminator's update against a
  detached fake, then the generator's update against the updated
  discriminator. The vocoder has no dropout or noise, so one generator
  forward serves both halves (the JAX step runs it twice and gets the
  same fake); the real audio's features for feature matching come from a
  forward of the updated discriminator without gradients;
- evaluation through the criterion's ``__call__`` (the generator's
  reconstruction metrics); ``steps_per_call > 1`` trains step by step, with
  a warning, as there.

Over several ranks each branch's gradients are averaged over the data
group before its clip, as the base trainer's are (JAX
``tests/test_parallel.py:test_gan_step_data_parallel_matches_single_device``).
"""

from __future__ import annotations

import logging

import torch

from ..parallel.context import activated
from ..parallel.mesh import all_reduce_mean, global_grad_norm, reduce_gradients
from .optimizers import build_optimizer, finite_or_nan, grad_norm, jax_param_name, \
    set_learning_rate
from .trainer import Trainer

logger = logging.getLogger("isp_tts_tpu_torch")

BRANCHES = (("gen", "generator"), ("disc", "discriminator"))
_FEATURE_KEYS = ("sample_rate", "n_fft", "hop_length", "win_length", "n_mels", "f_min",
                 "f_max")


class GANTrainer(Trainer):
    CHUNKED = False

    def __init__(self, model, criterion, config, **kwargs):
        if not (hasattr(model, "generator") and hasattr(model, "discriminator")):
            raise ValueError("GANTrainer requires a model with .generator and "
                             ".discriminator submodules")
        # the mel loss's contract is the model's feature front end
        if hasattr(model, "features_config") and hasattr(criterion, "config"):
            for name in _FEATURE_KEYS:
                if hasattr(criterion.config, name):
                    setattr(criterion.config, name, getattr(model.features_config, name))
        if config.steps_per_call > 1:
            logger.warning("steps_per_call > 1 is not supported by GANTrainer; "
                           "training per-step")
        super().__init__(model, criterion, config, **kwargs)

    # -- optimizers ------------------------------------------------------------

    def _init_optimizer(self):
        cfg = self.config
        self.optimizers = {}
        for key, branch in BRANCHES:
            module = getattr(self.model, branch)
            trainable = None
            if self.model.frozen_prefixes:
                params = dict(module.named_parameters())
                trainable = {n for n in params if self.model.is_trainable(
                    f"{branch}.{jax_param_name(module, n)[0]}")}
                logger.info("%s: optimizing %d / %d params", branch,
                            sum(params[n].numel() for n in trainable),
                            sum(p.numel() for p in params.values()))
            self.optimizers[key], schedule = build_optimizer(
                cfg.optimization, module, trainable, key_prefix=f"['{key}']")
            if key == "gen":
                self.schedule = schedule
            self._distribute(self.optimizers[key])
        if self._restored_base_lr is not None and cfg.restore_lr:
            self.schedule.base_lr = float(self._restored_base_lr)
        if self._restored_opt_state is not None:
            keyed = self._restored_opt_state
            parts = {key: {k: v for k, v in keyed.items() if k.startswith(f"['{key}']")}
                     for key, _ in BRANCHES}
            unknown = [k for k in keyed if not any(k in p for p in parts.values())]
            if unknown:
                raise ValueError(f"optimizer state does not match the checkpoint: unknown "
                                 f"keys {unknown[:5]}; pass restore_optimizer=false to "
                                 "reinitialize")
            for key, _ in BRANCHES:
                self.optimizers[key].load_keyed_state(parts[key], local=self._split_local)

    def _set_lr(self, lr: float) -> None:
        for opt in self.optimizers.values():
            set_learning_rate(opt, lr)

    def optimizer_keyed_state(self) -> dict:
        return {k: v for opt in self.optimizers.values()
                for k, v in opt.keyed_state(full=self._split_full).items()}

    # -- the step ----------------------------------------------------------------

    def _amp(self, device_type: str):
        """The training precision's autocast (off in f32)."""
        return torch.autocast(device_type, dtype=self._autocast or torch.bfloat16,
                              enabled=self._autocast is not None)

    def _branch_step(self, key: str, module: torch.nn.Module, loss: torch.Tensor):
        """Backward of ``loss`` into ``module``'s parameters alone, then its
        optimizer; returns the gradients' global norm (NaN if not finite)
        and whether the optimizer updated the parameters."""
        params = list(module.parameters())
        opt = self.optimizers[key]
        opt.zero_grad()
        loss.backward(inputs=params)
        for p in params:
            if p.grad is None:  # optax decays and steps every parameter
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if opt.parallel is None:
            norm = grad_norm(grads)
        else:
            # each micro-step's gradients reduced (the logged norm is the
            # global micro-batch's)
            reduce_gradients(grads, params, self.parallel_ctx)
            norm = global_grad_norm(grads, params, self.parallel_ctx)
        return finite_or_nan(norm), opt.step(norm)

    def _update(self, batch: dict, noise=None, t=None, step: int | None = None):
        """One GAN step: the discriminator's update, then the generator's.
        Returns the JAX trainer's metrics as 0-dim device tensors and
        whether the optimizers updated the parameters."""
        with activated(self.parallel_ctx), self.precision_scope():
            return self._gan_update(batch)

    def _gan_update(self, batch: dict):
        self.model.train()
        inputs = self.model.prepare_inputs(self._to_device(batch))
        audio = inputs["audio"]
        gen, disc = self.model.generator, self.model.discriminator
        dev = audio.device.type
        # the reconstruction target is always the real audio's mel; the
        # generator's input is a paired predicted mel where the batch has one
        mel_target = self.model.features(audio).detach()
        mel = inputs.get("mel", mel_target)
        # each forward in an autocast region of its own: the cast weights
        # are cached within one, and the discriminator's change between them
        with self._amp(dev):
            fake = gen(mel)
        with self._amp(dev):
            d_loss, d_metrics = self.criterion.disc_loss(disc, audio, fake.detach())
        d_norm, emitted = self._branch_step("disc", disc, d_loss.float())
        with torch.no_grad(), self._amp(dev):
            _, feats_real = disc(audio)
        with self._amp(dev):
            g_loss, g_metrics = self.criterion.gen_loss(disc, audio, fake, mel_target,
                                                        feats_real=feats_real)
        g_norm, _ = self._branch_step("gen", gen, g_loss.float())
        metrics = {"loss": g_loss.detach().float(),
                   **{k: v.detach().float() for k, v in d_metrics.items()},
                   **{k: v.detach().float() for k, v in g_metrics.items()},
                   "stats/grad_norm": g_norm, "stats/grad_norm_disc": d_norm}
        return all_reduce_mean(metrics, self.parallel_ctx), emitted

    def _forward(self, batch: dict, noise=None, t=None, step: int | None = None):
        inputs = self.model.prepare_inputs(self._to_device(batch))
        with self._amp(inputs["audio"].device.type):
            outputs = self.model(**inputs)
        step = self.state.global_step if step is None else step
        loss, losses = self.criterion(inputs, outputs, step)
        return loss, losses, outputs, inputs
