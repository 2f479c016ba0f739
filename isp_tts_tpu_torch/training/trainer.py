"""The trainer: the training step, the epoch loop, evaluation, checkpoints.

Counterpart of ``isp_tts_tpu/training/trainer.py``. One step is forward,
loss, backward, the global gradient norm and the optax-equivalent update
(:class:`~isp_tts_tpu_torch.training.optimizers.Optimizer`). With
``precision`` bf16 or fp16 the forward runs under ``torch.autocast`` in
that dtype over float32 master weights (no loss scaling, as there); the
products the JAX policy keeps in float32 run with autocast off.

Around the step, as there: the epoch and ``max_steps`` loop with gradient
accumulation counted in optimizer steps; the log/eval/save strategies of
:class:`~isp_tts_tpu_torch.training.callbacks.DefaultFlowCallback`;
metric means that surface non-finite values (:class:`Accumulator`);
evaluation with the evaluator's metrics and best-metric tracking;
``checkpoint_{sN,eN,last,best}.ckpt`` in the JAX format (``isp_tts_tpu.v1``:
the experiment, the model in JAX names and layouts, the optimizer keyed by
optax's tree paths), written whatever ends the run; full resume and warm
start (``ignore_layers``, ``ignore_mismatched_keys``, ``restore_optimizer``,
``restore_lr``); the freeze mask; chunked steps (``steps_per_call``: K steps
run back to back, then their flags are replayed per step, so a save or an
evaluation in mid-chunk sees the post-chunk weights); a ``torch.profiler``
trace of ``profile_steps`` into the run directory.

Randomness: dropout, the attention kernels' seeds and the flow predictor's
noise all draw from one generator on the device, which each micro-step
reseeds from the trainer's base seed and the micro-step's index (and each
evaluation batch from the step and its index). So a resumed run draws what
the uninterrupted run drew, with nothing stored. A full resume from the
port's own checkpoint also skips the batches of its epoch that were
already consumed (``epoch_batches_done`` in the saved state, a key the JAX
loader passes over); the JAX trainer, and the port on a JAX file, replay
the epoch from its start.

Several cards (one process a card, ``torch.distributed`` initialised by
the caller: ``python -m isp_tts_tpu_torch.train --distributed`` under
torchrun) split the axes of ``make_mesh(data=-1, model=mesh_model_axis,
seq=mesh_seq_axis, stage=mesh_pipeline_axis)``, as the JAX trainer's mesh
does: each data rank loads its contiguous rows of every global batch
(fixed-shape collation, so every rank pads to one shape), and the ranks
that differ only along the other axes load the same rows; the model axis
splits the attention heads and the feed-forward inner dim, in stacked
layer stacks too (``parallel.mesh.shard_params``); the seq axis rings ``flash: ring``
attention over its ranks; the stage axis cuts ``pipeline: true`` layer
stacks into stages (``parallel.mesh.shard_stages``) run as a GPipe
schedule of ``pipeline_microbatches``. Everything else is computed alike
on the seq and stage peers (the aligner too), so their gradients of it are
equal. After each micro-step's backward the gradients are averaged over
the data group alone in a few flat buckets (so the logged micro-step
gradient norm is the global micro-batch's, as JAX logs it) and the clip
reads the global norm (a stage's layers counted once over the stage
group, a model shard of them once over both groups); every rank's generator is the same stream and each keeps its rows
of the global draws, so N ranks compute one rank's step. Metrics are
averaged over the data group; rank 0 alone logs and writes checkpoints,
with split tensors, a stage's layers and their moments gathered, between
barriers, so a file is one rank's; every rank loads a checkpoint and
slices its part.

``precision: fp32`` computes in full float32 on the card: the step, the
evaluation and the GAN step run with cuDNN's and cuBLAS's TF32 off and
cuDNN's deterministic algorithms (restored on exit, never set for the
process), as the JAX package's f32 on the CPU, which the port is held to,
so two runs of the same steps are bit-equal. No recipe trains in fp32.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..config.registry import config_to_dict
from ..data.loader import DataLoader
from ..nn.layers import set_dropout_generator
from ..parallel.context import ParallelContext, activated
from ..parallel.mesh import (all_reduce_mean, barrier, full_parameters, full_part,
                             global_grad_norm, local_part, make_context, make_mesh,
                             reduce_gradients, replicate, shard_batch, shard_params,
                             shard_stages)
from ..utils.device import resolve_device
from .callbacks import (CALLBACKS, CallbackHandler, DefaultFlowCallback, ProgressCallback,
                        TrackerCallback, TrainerCallback, TrainerControl, TrainerState,
                        set_random_seed)
from .optimizers import build_optimizer, finite_or_nan, grad_norm, set_learning_rate
from .trainer_config import TrainerConfig

logger = logging.getLogger("isp_tts_tpu_torch")

CHECKPOINT_PREFIX = "checkpoint"
LAST_CHECKPOINT = "checkpoint_last.ckpt"
BEST_CHECKPOINT = "checkpoint_best.ckpt"
TRAINER_STATE_FILE = "trainer_state.json"

_AUTOCAST = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "fp16": torch.float16, "float16": torch.float16}
_M63 = 2**63 - 1


class Accumulator:
    """Running means of scalar metrics. Values stay as they come (device
    tensors included) until :meth:`means`, so a step forces no sync; a
    non-finite value is left out of its mean and counted in
    ``stats/nonfinite``."""

    def __init__(self):
        self.values: dict[str, list] = {}
        self.nonfinite = 0

    def add(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self.values.setdefault(k, []).append(v)

    def means(self) -> dict:
        out = {}
        dropped: dict[str, int] = {}
        for k, vals in self.values.items():
            floats = [f for f in map(float, vals) if np.isfinite(f)]
            if len(vals) - len(floats):
                dropped[k] = len(vals) - len(floats)
            if floats:
                out[k] = sum(floats) / len(floats)
        if dropped:
            self.nonfinite = sum(dropped.values())
            logger.warning("Accumulator: dropped %d non-finite metric value(s) from the "
                           "logged means: %s", self.nonfinite,
                           ", ".join(f"{k} x{n}" for k, n in sorted(dropped.items())))
            out["stats/nonfinite"] = float(self.nonfinite)
        return out

    def reset(self) -> None:
        self.values.clear()
        self.nonfinite = 0


def _plain_config(cfg: Any) -> Any:
    if hasattr(cfg, "items"):
        return {str(k): _plain_config(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_plain_config(v) for v in cfg]
    if isinstance(cfg, (datetime.date, Path)):
        return str(cfg)
    return cfg


class Trainer:
    #: whether ``steps_per_call > 1`` runs chunks of steps back to back
    CHUNKED = True

    def __init__(self, model: torch.nn.Module, criterion, config: TrainerConfig,
                 train_dataset=None, eval_dataset=None, collator=None, evaluator=None,
                 callbacks: list[TrainerCallback] | None = None,
                 experiment_config: dict | None = None,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.criterion = criterion
        self.config = config
        self.evaluator = evaluator
        self.experiment_config = experiment_config or {}
        self.parallel_ctx = self._make_parallel_context()
        self.is_main_process = self.parallel_ctx.rank == 0
        self.state = TrainerState(is_main_process=self.is_main_process)
        self.control = TrainerControl()
        self.run_dir = Path(config.run_dir)
        self._eval_image_batch = None
        self._micro_step = 0
        self._skip_batches = 0
        self._profiler = None
        #: wall seconds of each checkpoint write and of the resume load
        self.save_seconds: list[float] = []
        self.load_seconds: float | None = None

        # the host's generators, as the JAX trainer seeds them; the step draws
        # from its own generator, and torch's default ones are left alone
        set_random_seed(config.seed, torch_generators=False)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(
            config.seed)
        self._seed_base = self.generator.initial_seed()
        set_dropout_generator(self.model, self.generator)
        self._autocast = _AUTOCAST.get(config.precision)

        self.collator = collator
        multi = self.parallel_ctx.data_size > 1
        if ((config.steps_per_call > 1 or multi) and collator is not None
                and hasattr(getattr(collator, "config", None), "fixed_shape")
                and not collator.config.fixed_shape):
            # the K batches of a chunk share one shape; the data ranks' rows
            # of one global batch share one shape
            why = "multi-process" if multi else f"steps_per_call={config.steps_per_call}"
            if collator.config.max_text_len is None or collator.config.max_mel_len is None:
                raise ValueError(
                    f"{why} training requires fixed-shape "
                    "collation, which needs collator max_text_len AND max_mel_len set")
            collator.config.fixed_shape = True
        self.train_loader = (self._make_loader(train_dataset, config.batch_size,
                                               shuffle=config.shuffle)
                             if train_dataset is not None else None)
        self.eval_loader = (self._make_loader(eval_dataset, config.eval_batch_size,
                                              shuffle=False)
                            if eval_dataset is not None else None)

        cbs: list[TrainerCallback] = [DefaultFlowCallback()]
        for name, kwargs in (config.callbacks or {}).items():
            kwargs = {k: v for k, v in (kwargs or {}).items() if not k.startswith("_")}
            cbs.append(CALLBACKS.get(name)(**kwargs))
        if config.progress and not config.disable_tqdm:
            cbs.append(ProgressCallback())
        if tuple(config.log_with or ()):
            cbs.append(TrackerCallback(str(self.run_dir / "tb")))
        cbs.extend(callbacks or [])
        self.callbacks = CallbackHandler(cbs)

        self._maybe_load_checkpoint()
        # every rank starts from rank 0's weights (built alike from one seed,
        # they agree already); the model axis splits the full (loaded)
        # parameters, the stage axis keeps each stage's layers, and the
        # optimizer is built over the parts
        replicate(self.model)
        shard_params(self.model, self.parallel_ctx)
        shard_stages(self.model, self.parallel_ctx)
        self._init_optimizer()
        if config.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.callbacks.on_init_end(self.config, self.state, self.control)

    @property
    def global_step(self) -> int:
        return self.state.global_step

    # -- set-up ----------------------------------------------------------------

    def _make_parallel_context(self) -> ParallelContext:
        """The data × model × seq × stage layout of the process group's
        ranks (one process, no group: the plain one-device context)."""
        cfg = self.config
        if not torch.distributed.is_initialized():
            for axis in ("mesh_model_axis", "mesh_seq_axis", "mesh_pipeline_axis"):
                if getattr(cfg, axis) > 1:
                    raise ValueError(f"{axis} = {getattr(cfg, axis)} needs one process a "
                                     "card: run under torchrun with --distributed")
            return ParallelContext(n_micro=cfg.pipeline_microbatches)
        world = torch.distributed.get_world_size()
        if cfg.num_devices and cfg.num_devices < world:
            raise ValueError(f"num_devices = {cfg.num_devices}, but {world} ranks run: one "
                             "process a card, launch num_devices of them")
        backend = torch.distributed.get_backend()
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"a {backend} process group trains on its device type, not on "
                             f"{self.device}")
        ctx = make_context(make_mesh(data=-1, model=cfg.mesh_model_axis, seq=cfg.mesh_seq_axis,
                                     stage=cfg.mesh_pipeline_axis, world_size=world),
                           n_micro=cfg.pipeline_microbatches)
        logger.info("rank %d of %d: data %d/%d, model %d/%d, seq %d/%d, stage %d/%d on %s",
                    ctx.rank, world, ctx.data_rank, ctx.data_size, ctx.model_rank,
                    ctx.model_size, ctx.seq_rank, ctx.seq_size, ctx.stage_rank,
                    ctx.stage_size, self.device)
        return ctx

    def _make_loader(self, dataset, batch_size, shuffle):
        ctx = self.parallel_ctx
        return DataLoader(dataset, self.collator, batch_size=batch_size, shuffle=shuffle,
                          drop_last=self.config.drop_last, seed=self.config.seed,
                          num_shards=ctx.data_size, shard_index=ctx.data_rank)

    def _split_local(self, param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a parameter-shaped full tensor."""
        return local_part(param, full, self.parallel_ctx)

    def _split_full(self, param: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        """The full tensor of a parameter-shaped part (every rank calls it)."""
        return full_part(param, local, self.parallel_ctx)

    @contextmanager
    def precision_scope(self):
        """fp32 on the card computes in full float32 and repeats itself:
        cuDNN's and cuBLAS's TF32 off and cuDNN's deterministic algorithms
        within the block (its float32 convolution algorithms otherwise sum
        in a run-dependent order), the settings restored on exit."""
        if self._autocast is not None or self.device.type != "cuda":
            yield
            return
        backends = torch.backends
        saved = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
                 backends.cudnn.deterministic)
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
        backends.cudnn.deterministic = True
        try:
            yield
        finally:
            (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
             backends.cudnn.deterministic) = saved

    def _init_optimizer(self):
        trainable = None
        if getattr(self.model, "frozen_prefixes", None):
            params = dict(self.model.named_parameters())
            trainable = {n for n, (jname, _) in self.model.jax_names().items()
                         if n in params and self.model.is_trainable(jname)}
            logger.info("optimizing %d / %d params",
                        sum(params[n].numel() for n in trainable),
                        sum(p.numel() for p in params.values()))
        self.optimizer, self.schedule = build_optimizer(self.config.optimization, self.model,
                                                        trainable)
        if self._restored_base_lr is not None and self.config.restore_lr:
            self.schedule.base_lr = float(self._restored_base_lr)
        self._distribute(self.optimizer)
        if self._restored_opt_state is not None:
            self.optimizer.load_keyed_state(self._restored_opt_state, local=self._split_local)

    def _distribute(self, optimizer) -> None:
        """Hand an optimizer the parallel context (the clip's global norm)
        when several ranks run."""
        if torch.distributed.is_initialized():
            optimizer.parallel = self.parallel_ctx

    def _set_lr(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    def optimizer_keyed_state(self) -> dict:
        """The optimizer's state under optax's tree paths (the checkpoint's
        ``optimizer.keyed``), split tensors gathered whole."""
        return self.optimizer.keyed_state(full=self._split_full)

    def _maybe_load_checkpoint(self):
        cfg = self.config
        self._restored_opt_state = None
        self._restored_base_lr = None
        if cfg.finetune_layers is not None:
            self.model.freeze(list(cfg.finetune_layers))
        path = cfg.resume_from_checkpoint
        if not path:
            return
        t0 = time.perf_counter()
        # rank 0 reads first, then the others (the reference's
        # main_process_first around its load)
        barrier("checkpoint_load_enter")
        if self.is_main_process:
            ckpt = load_checkpoint(path)
        barrier("checkpoint_load_main_first")
        if not self.is_main_process:
            ckpt = load_checkpoint(path)
        ignore = list(cfg.ignore_layers) if cfg.warm_start else []
        state = ckpt["model"]["state"]
        torch_file = ckpt.get("format") == "torch"
        if torch_file:
            # a reference .pt: the model class maps its names onto the port's
            # (the model is built, so the converted config is not used)
            _, state = type(self.model).convert_torch_checkpoint(
                ckpt["model"].get("config", {}), state)
        self.model.load_params(state, ignore_layers=ignore,
                               ignore_mismatched=cfg.ignore_mismatched_keys,
                               port_names=torch_file)
        if not cfg.warm_start:
            exp_state = ckpt.get("experiment", {}).get("state")
            if not exp_state:
                sidecar = Path(path).parent / TRAINER_STATE_FILE
                if sidecar.exists():
                    exp_state = dataclasses.asdict(TrainerState.from_json(sidecar))
                    logger.info("trainer state restored from %s", sidecar)
            if exp_state:
                names = {f.name for f in dataclasses.fields(TrainerState)}
                for k, v in exp_state.items():
                    if k in names and k != "is_main_process":
                        setattr(self.state, k, v)
                # the port's own files say how far into its epoch they were
                # written; a JAX file (which replays its epoch) does not
                self._skip_batches = int(exp_state.get("epoch_batches_done", 0))
                # optax's count of micro-steps, from the state's own counters
                self._micro_step = (int(self.state.global_step)
                                    * cfg.optimization.grad_accum_steps)
        if (cfg.restore_optimizer or not cfg.warm_start) and "optimizer" in ckpt:
            blob = ckpt["optimizer"]
            if blob.get("keyed") is None:
                raise ValueError(f"{path}: the optimizer state is not path-keyed; pass "
                                 "restore_optimizer=false")
            self._restored_opt_state = blob["keyed"]
            self._restored_base_lr = blob.get("base_lr")
            # micro-steps into an accumulation (each optimizer's, equal)
            mini = [v for k, v in blob["keyed"].items() if k.endswith(".mini_step")]
            if mini:
                self._micro_step += int(np.asarray(mini[0]))
        self.load_seconds = time.perf_counter() - t0
        logger.info("loaded %s (warm_start=%s) in %.2f s", path, cfg.warm_start,
                    self.load_seconds)

    # -- one step --------------------------------------------------------------

    def _reseed(self, salt: int) -> None:
        self.generator.manual_seed((self._seed_base * 1_000_003 + salt * 7919 + 1) & _M63)

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, non_blocking=True)
        return out

    def _forward(self, batch: dict, noise=None, t=None, step: int | None = None):
        inputs = self.model.prepare_inputs(self._to_device(batch))
        with torch.autocast(self.device.type, dtype=self._autocast or torch.bfloat16,
                            enabled=self._autocast is not None):
            outputs = self.model(**inputs, noise=noise, t=t, generator=self.generator)
        step = self.state.global_step if step is None else step
        loss, losses = self.criterion(inputs, outputs, step)
        return loss, losses, outputs, inputs

    def compute_gradients(self, batch: dict, noise=None, t=None, step: int | None = None):
        """Forward, loss and backward on ``batch`` (a collated dict);
        ``noise``/``t`` fix the flow predictor's draws. Returns (loss, loss
        dict, global gradient norm of every parameter); the gradients are
        left in ``.grad`` unclipped (the optimizer clips)."""
        self.model.train()
        self._reseed(self._micro_step)
        self.optimizer.zero_grad()
        with activated(self.parallel_ctx), self.precision_scope():
            loss, losses, _, _ = self._forward(batch, noise, t, step)
            loss.backward()
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:  # optax decays and steps every parameter
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.optimizer.parallel is not None:
            # every micro-step's gradients are the global micro-batch's mean,
            # so the logged norm is JAX's; an accumulation of them needs no
            # reduction when applied
            reduce_gradients(grads, params, self.parallel_ctx)
        # every gradient's norm: the logged one, and the clip's when nothing
        # is frozen or accumulated (Optimizer.step); with several ranks the
        # global one (a split tensor counted once)
        self._grad_norm = (grad_norm(grads) if self.optimizer.parallel is None
                           else global_grad_norm(grads, params, self.parallel_ctx))
        return (loss.detach(), {k: v.detach() for k, v in losses.items()},
                finite_or_nan(self._grad_norm))

    def _update(self, batch: dict, noise=None, t=None, step: int | None = None
                ) -> tuple[dict, bool]:
        """One micro-step: gradients, then the optimizer. Returns the JAX
        trainer's metric names as 0-dim device tensors, and whether the
        optimizer updated the parameters."""
        loss, losses, norm = self.compute_gradients(batch, noise, t, step)
        emitted = self.optimizer.step(self._grad_norm)
        return all_reduce_mean({"loss": loss.float(), **{k: v.float() for k, v in losses.items()},
                                "stats/grad_norm": norm}, self.parallel_ctx), emitted

    def train_step(self, batch: dict, noise=None, t=None) -> dict[str, torch.Tensor]:
        """One micro-step on ``batch``, counted; the metrics as 0-dim tensors."""
        metrics, emitted = self._update(batch, noise, t)
        self._micro_step += 1
        if emitted:
            self.state.global_step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, noise=None, t=None, salt: int = 0):
        """(model outputs, metrics) in eval mode: no dropout, no update."""
        self.model.eval()
        self._reseed(-1 - salt)
        with activated(self.parallel_ctx), self.precision_scope():
            loss, losses, outputs, _ = self._forward(batch, noise, t)
        return outputs, all_reduce_mean(
            {"loss": loss.float(), **{k: v.float() for k, v in losses.items()}},
            self.parallel_ctx)

    # -- the loop --------------------------------------------------------------

    def train(self, batches: list[dict] | None = None, steps: int | None = None):
        """With ``batches``: ``steps`` micro-steps cycling over them (one
        pass an epoch; under a data split each rank trains on its rows of
        these global batches), each step's metrics as floats. Without: the
        run the config describes, over the trainer's datasets, with the
        final save whatever ends it; under ``eval_mode`` one evaluation pass
        instead, whose metrics it returns."""
        with activated(self.parallel_ctx):
            if batches is not None:
                return self._train_on([shard_batch(b, self.parallel_ctx) for b in batches],
                                      steps or len(batches))
            try:
                return self._train()
            finally:
                self._stop_profiler()
                if self.state.global_step > 0:
                    self._save_checkpoint(LAST_CHECKPOINT)
                    if self.is_main_process:
                        self.state.to_json(self.run_dir / TRAINER_STATE_FILE)

    def _train_on(self, batches: list[dict], steps: int) -> list[dict[str, float]]:
        history = []
        for _ in range(steps):
            batch = batches[self._micro_step % len(batches)]
            lr = self.schedule(self.state.global_step, self._micro_step // len(batches))
            self._set_lr(lr)
            metrics = {k: float(v) for k, v in self.train_step(batch).items()}
            metrics["stats/learning_rate"] = lr
            history.append(metrics)
        return history

    def _train(self):
        cfg = self.config
        if not cfg.do_train:
            logger.warning("`do_train` is False, skipping training.")
            if cfg.do_eval and self.eval_loader is not None:
                return self.evaluate()
            return None
        if self.train_loader is None:
            raise ValueError("no train dataset")
        steps_per_epoch = max(len(self.train_loader) // cfg.optimization.grad_accum_steps, 1)
        if cfg.max_steps:
            max_steps = cfg.max_steps
            epochs = -(-max_steps // steps_per_epoch)
        else:
            epochs = cfg.epochs
            max_steps = steps_per_epoch * epochs
        self.state.max_steps = max_steps
        self.state.num_train_epochs = epochs
        logger.info("training: samples=%d epochs=%d steps/epoch=%d max_steps=%d "
                    "batch=%d grad_accum=%d on %s", len(self.train_loader.dataset), epochs,
                    steps_per_epoch, max_steps, cfg.batch_size,
                    cfg.optimization.grad_accum_steps, self.device)
        self.control.is_train = True
        self.callbacks.on_train_begin(cfg, self.state, self.control)
        if cfg.eval_first_step and cfg.do_eval:
            self.evaluate()
        for epoch in range(int(self.state.epoch), epochs):
            self.state.epoch = float(epoch)
            self.run_epoch(self.train_loader, is_train=True)
            if self.control.should_training_stop:
                break
        self.callbacks.on_train_end(cfg, self.state, self.control)

    def run_epoch(self, loader, is_train: bool = True):
        cfg = self.config
        loader.set_epoch(int(self.state.epoch))
        if is_train:
            self.control.reset_epoch()
            self.callbacks.on_epoch_begin(cfg, self.state, self.control)
        epoch_acc, step_acc = Accumulator(), Accumulator()
        self.state.epoch_step = 0
        if is_train and self._skip_batches:
            # a resumed epoch goes on after the batches its checkpoint consumed
            loader.skip, self.state.epoch_step = self._skip_batches, self._skip_batches
            self._skip_batches = 0
        try:
            if is_train and cfg.steps_per_call > 1 and self.CHUNKED:
                return self._run_epoch_chunked(loader, epoch_acc, step_acc)
            data_t0 = time.perf_counter()
            for index, host_batch in enumerate(loader):
                data_time = time.perf_counter() - data_t0
                if is_train:
                    self._train_micro(host_batch, step_acc, epoch_acc, data_time)
                else:
                    self._eval_batch(index, host_batch, step_acc, epoch_acc, data_time)
                    if cfg.eval_batches and self.state.epoch_step >= cfg.eval_batches:
                        break
                if self.control.should_training_stop or self.control.should_epoch_stop:
                    break
                data_t0 = time.perf_counter()
            if is_train:
                self._end_epoch(step_acc)
            return epoch_acc.means()
        finally:
            loader.skip = 0

    def _end_epoch(self, step_acc):
        self.callbacks.on_epoch_end(self.config, self.state, self.control)
        self._maybe_log_save_evaluate(step_acc)
        self.state.epoch = float(int(self.state.epoch) + 1)
        self.state.epoch_step = 0

    def _eval_batch(self, index, host_batch, step_acc, epoch_acc, data_time):
        self.callbacks.on_step_begin(self.config, self.state, self.control)
        model_t0 = time.perf_counter()
        outputs, metrics = self.eval_step(host_batch, salt=self.state.global_step * 4096 + index)
        if self.evaluator is not None:
            inputs = self.model.prepare_inputs(self._to_device(host_batch))
            metrics = {**metrics, **all_reduce_mean(self.evaluator(inputs, outputs),
                                                    self.parallel_ctx)}
            if self._eval_image_batch is None:
                self._eval_image_batch = (host_batch, outputs)
        model_time = time.perf_counter() - model_t0
        metrics.update({"stats/time/data": data_time, "stats/time/model": model_time,
                        "stats/time": data_time + model_time})
        step_acc.add(metrics)
        epoch_acc.add(metrics)
        self.state.epoch_step += 1

    def _after_micro(self, step_acc, epoch_acc, metrics):
        """The accounting of one micro-step (counters, callbacks, flags)."""
        cfg = self.config
        step_acc.add(metrics)
        epoch_acc.add(metrics)
        self._micro_step += 1
        self.state.epoch_step += 1
        if self._micro_step % cfg.optimization.grad_accum_steps == 0:
            self.state.global_step += 1
            self._maybe_profile()
            self.callbacks.on_step_end(cfg, self.state, self.control)
            self._maybe_log_save_evaluate(step_acc)
        else:
            self.callbacks.on_substep_end(cfg, self.state, self.control)

    def _train_micro(self, host_batch, step_acc, epoch_acc, data_time):
        self.callbacks.on_step_begin(self.config, self.state, self.control)
        model_t0 = time.perf_counter()
        lr = self.schedule(self.state.global_step, int(self.state.epoch))
        self._set_lr(lr)
        self.state.learning_rate = lr
        metrics, _ = self._update(host_batch)
        model_time = time.perf_counter() - model_t0
        metrics.update({"stats/time/data": data_time, "stats/time/model": model_time,
                        "stats/time": data_time + model_time})
        self._after_micro(step_acc, epoch_acc, metrics)

    def _run_epoch_chunked(self, loader, epoch_acc, step_acc):
        """A training epoch in chunks of K micro-steps; the epoch's tail (or
        the approach to ``max_steps``) runs per step, so step counts stay
        exact."""
        cfg = self.config
        K = cfg.steps_per_call
        g = cfg.optimization.grad_accum_steps
        it = iter(loader)
        pending: list = []
        exhausted = False
        data_t0 = time.perf_counter()
        while not (self.control.should_training_stop or self.control.should_epoch_stop):
            want = K
            if self.state.max_steps:
                rem = ((self.state.max_steps - self.state.global_step) * g
                       - self._micro_step % g)
                if rem <= 0:
                    break
                want = min(K, rem)
            while len(pending) < want and not exhausted:
                try:
                    pending.append(next(it))
                except StopIteration:
                    exhausted = True
            if not pending:
                break
            if len(pending) >= K and want == K:
                chunk, pending = pending[:K], pending[K:]
                self._dispatch_chunk(chunk, step_acc, epoch_acc, time.perf_counter() - data_t0)
            else:
                chunk, pending = pending[:want], pending[want:]
                data_time = (time.perf_counter() - data_t0) / len(chunk)
                for hb in chunk:
                    self._train_micro(hb, step_acc, epoch_acc, data_time)
                    if self.control.should_training_stop or self.control.should_epoch_stop:
                        break
            if exhausted and not pending:
                break
            data_t0 = time.perf_counter()
        it.close()
        self._end_epoch(step_acc)
        return epoch_acc.means()

    def _dispatch_chunk(self, chunk, step_acc, epoch_acc, data_time):
        """K micro-steps back to back, then the per-step accounting replayed
        with each step's metrics."""
        cfg = self.config
        g = cfg.optimization.grad_accum_steps
        K = len(chunk)
        lrs, steps = [], []
        sim_micro, sim_gs = self._micro_step, self.state.global_step
        for _ in range(K):
            lrs.append(float(self.schedule(sim_gs, int(self.state.epoch))))
            steps.append(sim_gs)
            sim_micro += 1
            if sim_micro % g == 0:
                sim_gs += 1
        self.callbacks.on_step_begin(cfg, self.state, self.control)
        model_t0 = time.perf_counter()
        device_batches = [self._to_device(b) for b in chunk]
        results = []
        micro = self._micro_step
        for i, batch in enumerate(device_batches):
            self._set_lr(lrs[i])
            self._micro_step = micro + i  # the step's generator seed
            results.append(self._update(batch, step=steps[i])[0])
        self._micro_step = micro
        model_time = time.perf_counter() - model_t0
        for i, metrics in enumerate(results):
            metrics.update({"stats/time/data": data_time / K, "stats/time/model": model_time / K,
                            "stats/time": (data_time + model_time) / K})
            self.state.learning_rate = lrs[i]
            self._after_micro(step_acc, epoch_acc, metrics)
            if self.control.should_training_stop or self.control.should_epoch_stop:
                self._micro_step = micro + K  # the chunk ran in full
                break

    def _maybe_profile(self):
        window = self.config.profile_steps
        if not window or not self.is_main_process:
            return
        start, end = int(window[0]), int(window[1])
        if self.state.global_step == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            logger.info("profiler trace started (steps %d..%d)", start, end)
        elif self.state.global_step == end:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = self.run_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(out / f"trace_s{self.state.global_step}.json"))
        self._profiler = None
        logger.info("profiler trace written to %s", out)

    def _maybe_log_save_evaluate(self, step_acc: Accumulator):
        cfg = self.config
        if self.control.should_log:
            logs = {f"train_step/{k}": v for k, v in step_acc.means().items()}
            logs["stats/learning_rate"] = self.state.learning_rate
            self.state.log_history.append({"step": self.state.global_step, **logs})
            self.callbacks.on_log(cfg, self.state, self.control, logs=logs)
            step_acc.reset()
        if self.control.should_evaluate and cfg.do_eval and self.eval_loader is not None:
            self.evaluate()
        if self.control.should_save and cfg.save_strategy != "no":
            self._save_on_strategy()
        self.control.reset_step()

    # -- evaluation --------------------------------------------------------------

    def evaluate(self, eval_dataset=None) -> dict:
        """One evaluation pass; ``eval_dataset`` replaces the configured
        split for this call. Under a data split each rank evaluates its
        rows and the metrics are averaged over the data group."""
        loader = (self._make_loader(eval_dataset, self.config.eval_batch_size, shuffle=False)
                  if eval_dataset is not None else self.eval_loader)
        if loader is None:
            raise ValueError("evaluate() called without an eval dataset")
        self._eval_image_batch = None
        was_train, prev_epoch_step = self.control.is_train, self.state.epoch_step
        self.control.is_train = False
        try:
            with activated(self.parallel_ctx):
                means = self.run_epoch(loader, is_train=False)
        finally:
            self.control.is_train = was_train
            self.state.epoch_step = prev_epoch_step
            self.model.train()
        logs = {f"eval/{k}": v for k, v in means.items()}
        if (self.evaluator is not None and self._eval_image_batch is not None
                and hasattr(self.evaluator, "on_eval_epoch_end")):
            batch, outputs = self._eval_image_batch
            try:
                logs.update(self.evaluator.on_eval_epoch_end(
                    self.model.prepare_inputs(self._to_device(batch)) | {
                        "filename": batch.get("filename")}, outputs))
            except Exception as e:  # noqa: BLE001 - figures must never stop training
                logger.warning("eval image logging failed: %s", e)
        scalars = {k: float(v) for k, v in logs.items() if isinstance(v, (int, float))}
        self.state.log_history.append({"step": self.state.global_step, **scalars})
        self.callbacks.on_log(self.config, self.state, self.control, logs=logs)
        self.callbacks.on_evaluate(self.config, self.state, self.control, metrics=logs)
        self._track_best_metric(means)
        return logs

    def _track_best_metric(self, means: dict):
        cfg = self.config
        key = cfg.metric_for_best_model
        if not key or not cfg.do_train:
            return
        value = means.get(key, means.get(f"metrics/{key}"))
        if value is None:
            return
        best = self.state.best_metric
        if best is None or (value > best if cfg.metric_maximize else value < best):
            self.state.best_metric = float(value)
            self._save_checkpoint(BEST_CHECKPOINT)
            self.state.best_model_checkpoint = str(self.run_dir / BEST_CHECKPOINT)

    # -- checkpoints -------------------------------------------------------------

    def _save_on_strategy(self):
        cfg = self.config
        if cfg.save_best_only:
            return
        name = (f"{CHECKPOINT_PREFIX}_s{self.state.global_step}.ckpt"
                if cfg.save_strategy == "steps"
                else f"{CHECKPOINT_PREFIX}_e{int(self.state.epoch)}.ckpt")
        if (cfg.save_rewrite_checkpoint and self.state.last_model_checkpoint
                and self.is_main_process):
            prev = Path(self.state.last_model_checkpoint)
            if prev.exists() and prev.name.startswith((CHECKPOINT_PREFIX + "_s",
                                                       CHECKPOINT_PREFIX + "_e")):
                prev.unlink(missing_ok=True)
        self._save_checkpoint(name)

    def checkpoint_payload(self) -> dict:
        """What a checkpoint holds: the ``isp_tts_tpu.v1`` payload, split
        tensors and a stage's layers gathered whole (a collective: every
        rank of a model or stage split calls it)."""
        with full_parameters(self.model, self.parallel_ctx):
            model_state = self.model.jax_state()
        payload = {
            "format": "isp_tts_tpu.v1",
            "experiment": {"config": _plain_config(self.experiment_config),
                           "trainer": config_to_dict(self.config),
                           # epoch_batches_done: not a TrainerState field, so
                           # the JAX loader passes over it
                           "state": {**dataclasses.asdict(self.state),
                                     "epoch_batches_done": self.state.epoch_step}},
            "model": {"class": type(self.model).__name__,
                      "config": config_to_dict(self.model.config),
                      "state": model_state},
        }
        if self.config.save_optimizer:
            payload["optimizer"] = {"keyed": self.optimizer_keyed_state(),
                                    "base_lr": float(self.schedule.base_lr)}
        return payload

    def _save_checkpoint(self, name: str):
        """Rank 0 writes the file (split tensors gathered on every rank);
        no rank goes on, or reads it, before the write ends."""
        t0 = time.perf_counter()
        path = self.run_dir / name
        ctx = self.parallel_ctx
        if self.is_main_process or ctx.model_size > 1 or ctx.stage_size > 1:
            payload = self.checkpoint_payload()  # gathers split tensors: a collective
        if self.is_main_process:
            save_checkpoint(path, payload)
        self.state.last_model_checkpoint = str(path)
        barrier(f"save_{name}")
        self.save_seconds.append(time.perf_counter() - t0)
        if self.is_main_process:
            self.callbacks.on_save(self.config, self.state, self.control)
            logger.info("saved checkpoint %s", path)
