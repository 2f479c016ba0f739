"""Optimizers, gradient clipping and LR schedules, as optax computes them.

Counterpart of ``isp_tts_tpu/training/optimizers.py``. There the optimizer
is an optax chain::

    MultiSteps(                                   # grad_accum_steps > 1
      multi_transform({train: inject_hyperparams(chain(
          clip_by_global_norm,                    # grad_clip_norm
          scale_by_adam | trace,                  # adamw | sgd (momentum)
          add_decayed_weights(mask=ndim >= 2),    # weight_decay
          scale_by_learning_rate)),
        freeze: set_to_zero}))                    # finetune_layers

:class:`Optimizer` computes the same update on torch tensors (with the
``torch._foreach`` ops: a handful of multi-tensor launches a step). The
clip norm and the moments cover the trained parameters only; frozen ones
get no moments and no decay. With accumulation every micro-step folds its
gradients into a running mean (optax's Welford form) and the k-th applies
the inner update to the mean. The counts optax keeps in device arrays
(``count``, ``mini_step``, ``gradient_step``) are host integers here: no
update is ever skipped, so they are known without a device read.

:meth:`Optimizer.keyed_state` names every leaf by its optax tree path
(``jax.tree_util.keystr``) in the JAX layout, as the JAX trainer's
checkpoints store them (``trainer.py:_save_checkpoint``), and
:meth:`Optimizer.load_keyed_state` takes such a dict back, from either
package; a set of keys that does not match raises, as
``_restore_opt_state`` does there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
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
    momentum: float = 0.0  # sgd
    grad_clip_norm: float | None = 1.0
    grad_accum_steps: int = 1
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)

    def __post_init__(self):
        if self._target_ not in ("adamw", "sgd"):
            raise KeyError(f"Unknown optimizer {self._target_!r}")
        if int(self.grad_accum_steps) < 1:
            raise ValueError("grad_accum_steps must be >= 1")


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


def jax_param_name(module: torch.nn.Module, name: str) -> tuple[str, bool | tuple]:
    """The JAX package's flat name of the port parameter ``name`` of
    ``module``, and its layout there (the inverse of
    :func:`~isp_tts_tpu_torch.models.base.torch_name`): an Embedding's
    ``weight`` is ``embedding``, any other ``weight`` of two or more axes a
    ``kernel`` with its axes reversed (True), and a one-axis ``weight`` a
    norm's ``scale``. A module's ``JAX_LAYOUTS`` maps a parameter of its
    own to the permutation that takes its axes to the JAX layout."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix) if prefix else module
    perm = getattr(owner, "JAX_LAYOUTS", {}).get(leaf)
    if perm is not None:
        return name, tuple(perm)
    if leaf != "weight":
        return name, False
    if isinstance(owner, torch.nn.Embedding):
        return f"{prefix}.embedding", False
    if module.get_parameter(name).dim() >= 2:
        return f"{prefix}.kernel", True
    return f"{prefix}.scale", False


def keystr(jax_name: str) -> str:
    """optax's tree path of an nnx parameter: ``a.b.0.kernel`` ->
    ``['a']['b'][0]['kernel'].value``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in jax_name.split(".")) + ".value"


def to_jax_array(arr: np.ndarray, layout: bool | tuple) -> np.ndarray:
    """A port-layout array in the JAX layout: reversed (True), permuted
    (a tuple of axes) or as it is (False)."""
    if layout is True:
        return arr.T
    return np.transpose(arr, layout) if layout else arr


def from_jax_array(arr: np.ndarray, layout: bool | tuple) -> np.ndarray:
    """The inverse of :func:`to_jax_array`."""
    if layout is True:
        return arr.T
    return np.transpose(arr, np.argsort(layout)) if layout else arr


def to_jax_layout(t: torch.Tensor, layout: bool | tuple) -> np.ndarray:
    return np.array(to_jax_array(t.detach().float().cpu().numpy(), layout), order="C")


def from_jax_layout(arr, layout: bool | tuple, like: torch.Tensor) -> torch.Tensor:
    arr = from_jax_array(np.asarray(arr), layout)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"optimizer leaf shape {arr.shape} does not fit {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(like.device, like.dtype)


class Optimizer:
    """optax's chain over a model's parameters (see the module docstring).

    ``trainable`` names the parameters the freeze mask trains (None: all).
    :meth:`step` reads every parameter's ``.grad`` (None counts as zero)
    and returns whether it updated the parameters (False on the first
    k - 1 micro-steps of an accumulation). ``grad_norm``, the global norm
    of every gradient when the caller has computed it (:func:`grad_norm`),
    is the clip's norm when every parameter is trained and nothing
    accumulates: the clip then needs no second pass over the gradients.
    ``key_prefix`` goes before every key of :meth:`keyed_state`: the JAX
    GANTrainer keeps one optimizer a branch under ``['gen']`` and
    ``['disc']``, each over its submodule's own tree (the port's names
    relative to the ``model`` passed, the branch)."""

    def __init__(self, config: OptimizationConfig, model: torch.nn.Module,
                 trainable: set[str] | None = None, key_prefix: str = ""):
        self.config = cfg = config
        self.key_prefix = key_prefix
        named = [(n, p) for n, p in model.named_parameters()]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.layout = {n: jax_param_name(model, n) for n in self.names}
        self.masked = trainable is not None
        self.trained = [i for i, n in enumerate(self.names)
                        if trainable is None or n in trainable]
        self.lr = float(cfg.learning_rate)
        self.accum = int(cfg.grad_accum_steps)
        self.clip = cfg.grad_clip_norm if cfg.grad_clip_norm and cfg.grad_clip_norm > 0 else None
        self.count = 0  # inner updates applied (optax's count, torch's step)
        self.mini_step = 0
        self.gradient_step = 0
        zeros = [torch.zeros_like(self.params[i]) for i in self.trained]
        self.mu = self.nu = self.trace = None
        if cfg._target_ == "adamw":
            self.mu, self.nu = zeros, [torch.zeros_like(z) for z in zeros]
        elif cfg.momentum:
            self.trace = zeros
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum > 1 else None

    # -- the update ----------------------------------------------------------

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grad_norm: torch.Tensor | None = None) -> bool:
        grads = self._grads()
        if self.acc is not None:
            n = self.mini_step
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (n + 1) % self.accum
            if n != self.accum - 1:
                return False
            self._inner([self.acc[i] for i in self.trained])
            for a in self.acc:
                a.zero_()
            self.gradient_step += 1
            return True
        self._inner([grads[i] for i in self.trained],
                    None if self.masked else grad_norm)
        return True

    def _inner(self, grads: list[torch.Tensor], norm: torch.Tensor | None = None) -> None:
        cfg = self.config
        params = [self.params[i] for i in self.trained]
        if not params:
            self.count += 1
            return
        if self.clip is not None:
            norm = grad_norm(grads) if norm is None else norm
            # optax: g if ||g|| < max else g / ||g|| * max
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        if cfg._target_ == "adamw":
            b1, b2 = (float(b) for b in cfg.betas)
            torch._foreach_lerp_(self.mu, grads, 1.0 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - b2)
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.int32(self.count))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.int32(self.count))
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, float(cfg.eps))
            updates = torch._foreach_div(self.mu, bc1)
            torch._foreach_div_(updates, denom)
        elif self.trace is not None:
            torch._foreach_mul_(self.trace, float(cfg.momentum))
            torch._foreach_add_(self.trace, grads)
            updates = [t.clone() for t in self.trace]
        else:
            updates = [g.clone() for g in grads]
        if cfg.weight_decay:
            decayed = [(u, p) for u, p in zip(updates, params) if p.dim() >= 2]
            if decayed:
                torch._foreach_add_([u for u, _ in decayed], [p for _, p in decayed],
                                    alpha=float(cfg.weight_decay))
        torch._foreach_add_(params, updates, alpha=-self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    # -- optax's tree paths ----------------------------------------------------

    def _prefix(self) -> str:
        base = self.key_prefix + (".inner_opt_state" if self.acc is not None else "")
        if self.masked:
            base += ".inner_states['train'].inner_state"
        return base

    def _slots(self) -> dict[str, list[torch.Tensor]]:
        idx = 1 if self.clip is not None else 0
        inner = f"{self._prefix()}.inner_state[{idx}]"
        if self.mu is not None:
            return {f"{inner}.mu": self.mu, f"{inner}.nu": self.nu}
        if self.trace is not None:
            return {f"{inner}.trace": self.trace}
        return {}

    def keyed_state(self) -> dict[str, np.ndarray]:
        """Every leaf of optax's state under its tree path, JAX layout."""
        pre = self._prefix()
        out = {f"{pre}.count": np.asarray(self.count, np.int32),
               f"{pre}.hyperparams['learning_rate']": np.asarray(self.lr, np.float32)}
        if self.mu is not None:
            idx = 1 if self.clip is not None else 0
            out[f"{pre}.inner_state[{idx}].count"] = np.asarray(self.count, np.int32)
        for slot, tensors in self._slots().items():
            for i, t in zip(self.trained, tensors):
                jname, rev = self.layout[self.names[i]]
                out[slot + keystr(jname)] = to_jax_layout(t, rev)
        if self.acc is not None:
            kp = self.key_prefix
            out[kp + ".mini_step"] = np.asarray(self.mini_step, np.int32)
            out[kp + ".gradient_step"] = np.asarray(self.gradient_step, np.int32)
            for n, t in zip(self.names, self.acc):
                jname, rev = self.layout[n]
                out[kp + ".acc_grads" + keystr(jname)] = to_jax_layout(t, rev)
        return out

    def load_keyed_state(self, keyed: dict) -> None:
        """Take back a :meth:`keyed_state` dict (the port's or the JAX
        trainer's); raises when the keys are not exactly this state's."""
        want = list(self.keyed_state())
        missing = [k for k in want if k not in keyed]
        unknown = [k for k in keyed if k not in set(want)]
        if missing or unknown:
            raise ValueError(
                "optimizer state does not match the checkpoint: "
                f"missing keys {missing[:5]}{'...' if len(missing) > 5 else ''}, "
                f"unknown keys {unknown[:5]}{'...' if len(unknown) > 5 else ''} "
                f"({len(missing)} missing / {len(unknown)} unknown of {len(want)}); "
                "pass restore_optimizer=false to reinitialize")
        pre = self._prefix()
        self.count = int(np.asarray(keyed[f"{pre}.count"]))
        self.lr = float(np.asarray(keyed[f"{pre}.hyperparams['learning_rate']"]))
        with torch.no_grad():
            for slot, tensors in self._slots().items():
                for i, t in zip(self.trained, tensors):
                    jname, rev = self.layout[self.names[i]]
                    t.copy_(from_jax_layout(keyed[slot + keystr(jname)], rev, t))
            if self.acc is not None:
                kp = self.key_prefix
                self.mini_step = int(np.asarray(keyed[kp + ".mini_step"]))
                self.gradient_step = int(np.asarray(keyed[kp + ".gradient_step"]))
                for n, t in zip(self.names, self.acc):
                    jname, rev = self.layout[n]
                    t.copy_(from_jax_layout(keyed[kp + ".acc_grads" + keystr(jname)], rev, t))


def build_optimizer(config: OptimizationConfig, model: torch.nn.Module,
                    trainable: set[str] | None = None,
                    key_prefix: str = "") -> tuple[Optimizer, Schedule]:
    """(the optax chain over ``model``'s parameters, its Schedule)."""
    return (Optimizer(config, model, trainable, key_prefix),
            Schedule(config.lr_scheduler, config.learning_rate))


def set_learning_rate(opt: Optimizer, lr: float) -> None:
    opt.lr = float(lr)


def grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of every element of ``grads``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [g.float() for g in grads])))


def finite_or_nan(norm: torch.Tensor) -> torch.Tensor:
    """``norm``, or NaN where it is not finite, so the trainer can flag it."""
    return torch.where(torch.isfinite(norm), norm, torch.full_like(norm, float("nan")))


def global_grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the parameters' gradients (optax.global_norm); NaN
    when any gradient is not finite."""
    return finite_or_nan(grad_norm([p.grad for p in params if p.grad is not None]))


def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / ||g|| * max_norm where
    ||g|| >= max_norm, untouched otherwise. Returns the norm before."""
    params = [p for p in params if p.grad is not None]
    norm = global_grad_norm(params)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([p.grad for p in params], scale)
    return norm
