"""Ranks of the port's multi-process tests: each a process of a gloo group
on the CPU, started through a ``file://`` store in a test's temporary
directory (never a fixed port, so test workers side by side never meet).

The parent writes the inputs (``inputs.npz``: JAX-named weights, batches,
flow draws) and starts ``world`` ranks with :func:`spawn`; every rank runs
every case it is given in turn and rank 0 writes each case's results to
``<out>/<case>.npz``; :func:`join` waits with a deadline of its own and
fails the test rather than hang. The same case functions run in the
parent with no process group, as one rank, for the reference. This module
imports no JAX: the ranks run the port alone.

Run as ``python tests/torch_port_parallel_workers.py --rank R --world N
--store FILE --inputs NPZ --out DIR --cases a,b``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

_LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                        "alibi_pos_bias": True, "dropout": 0.1},
          "feed_forward": {"inner_dim": 64, "activation": "gelu", "dropout": 0.1}}
_GLU = dict(_LAYER, feed_forward=dict(_LAYER["feed_forward"], glu=True))
_MHA = dict(_LAYER, attention=dict(_LAYER["attention"], one_kv_head=False,
                                   alibi_symmetric=False))
#: a small acoustic model whose every split divides over 2 model ranks:
#: 2 heads a layer, the decoder's feed-forward a GLU, the predictor with one
#: key/value head per query head; attention and feed-forward dropout 0.1
PAR = {
    "encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
    "mel_dim": 16,
    "text_dim": 64,
    "encoder": {"dim": 64, "depth": 1, "transformer_layer": _LAYER},
    "decoder": {"dim": 64, "depth": 1, "transformer_layer": _GLU},
    "temporal_adaptor": {
        "predictor": {"transformer": {"dim": 64, "depth": 1, "transformer_layer": _MHA},
                      "time_embedding_dim": 16},
        "embedding": {"transformer": {"dim": 64, "depth": 1, "transformer_layer": _LAYER}},
        "pitch": True, "energy": True, "soft_duration": True},
    "aligner": {"attention_dim": 8, "key_kernel_size": 5, "query_kernel_size": 3},
    "num_speakers": 2,
}


def with_ring(cfg: dict, parts=("encoder", "decoder")) -> dict:
    """``cfg`` with the attention of ``parts`` (the encoder's and the
    decoder's) ``flash: ring``."""
    out = dict(cfg)
    for part in parts:
        layer = cfg[part]["transformer_layer"]
        out[part] = dict(cfg[part], transformer_layer=dict(
            layer, attention=dict(layer["attention"], flash="ring")))
    return out


#: PAR with a stacked decoder of 2 layers (``pipeline: true``)
PAR_STAGE = dict(PAR, decoder=dict(PAR["decoder"], depth=2, pipeline=True))
#: the per-layer twin of PAR_STAGE (its weights' JAX names)
PAR_STAGE_LAYERS = dict(PAR, decoder=dict(PAR["decoder"], depth=2))


def without_dropout(cfg: dict) -> dict:
    """``cfg`` with every attention and feed-forward dropout 0."""
    if isinstance(cfg, dict):
        return {k: (0.0 if k == "dropout" else without_dropout(v)) for k, v in cfg.items()}
    return cfg


def global_batch(B: int = 4, T: int = 12, M: int = 48, seed: int = 13) -> dict:
    """A collated global batch (the collator's key names), ragged lengths."""
    rng = np.random.RandomState(seed)
    text_len = np.array([12, 9, 6, 11, 8, 12, 7, 10][:B], np.int32)
    text = rng.randint(2, 11, size=(B, T)).astype(np.int32)
    text[np.arange(T)[None] >= text_len[:, None]] = 0
    return {"text_vector": text, "text_vector_len": text_len,
            "mel": rng.randn(B, M, 16).astype(np.float32),
            "mel_len": np.array([48, 40, 30, 44, 36, 48, 33, 41][:B], np.int32),
            "pitch": rng.randn(B, M).astype(np.float32),
            "energy": rng.randn(B, M).astype(np.float32),
            "speaker": np.array([0, 1, 1, 0, 1, 0, 0, 1][:B], np.int32)}


def acoustic_trainer(flat: dict, outdir, model_axis: int, dropout: bool = True,
                     model: dict | None = None, ring_alone: bool = False, **trainer):
    """The port's Trainer over the PAR model (``model``: another config)
    with ``flat`` (JAX names) as its weights, float32 on the CPU, AdamW
    1e-3, clip 1.0 (``trainer``: more TrainerConfig keys). ``ring_alone``
    names a seq axis of size 1 in the trainer's one-process context, so
    ``flash: ring`` rings alone (the one-rank reference of a seq split)."""
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    import dataclasses

    cfg = model or PAR
    cfg = cfg if dropout else without_dropout(cfg)
    model = AcousticModel(build_config(AcousticModelConfig, cfg))
    model.load_jax_state(flat)
    config = build_config(TrainerConfig, {
        "precision": "fp32", "progress": False, "log_with": [], "output_dir": str(outdir),
        "experiment_name": "par", "mesh_model_axis": model_axis,
        "optimization": {"learning_rate": 1e-3, "grad_clip_norm": 1.0,
                         **trainer.pop("optimization", {})}, **trainer})
    tr = Trainer(model, AcousticModelLoss(), config, device="cpu")
    if ring_alone:
        tr.parallel_ctx = dataclasses.replace(tr.parallel_ctx, seq_axis="seq")
    return tr


def _full_grads(trainer) -> dict[str, np.ndarray]:
    """Every parameter's gradient, split ones and a stage's layers
    gathered whole."""
    from isp_tts_tpu_torch.parallel.mesh import full_part

    return {name: full_part(p, p.grad, trainer.parallel_ctx).detach().numpy().copy()
            for name, p in trainer.model.named_parameters()}


def case_steps(inputs: dict, outdir, model_axis: int, steps: int = 3, **layout) -> dict:
    """``steps`` micro-steps with live dropout on the global batch: each
    step's metrics, and the first step's gradients (``layout``: more
    :func:`acoustic_trainer` keys, such as the seq and stage axes)."""
    tr = acoustic_trainer(_flat(inputs, layout), outdir, model_axis, **layout)
    batch = _batch(inputs)
    out = {}
    for i in range(steps):
        metrics = tr.train(batches=[batch], steps=1)[0]
        for k, v in metrics.items():
            out.setdefault(f"m::{k}", []).append(v)
        if i == 0:
            out.update({f"g::{k}": v for k, v in _full_grads(tr).items()})
    return {k: np.asarray(v) for k, v in out.items()}


class _NudgeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gen):
        ctx.gen = gen
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * (1 + ULP * torch.randn(grad.shape, generator=ctx.gen)), None


#: one float32 rounding, relative
ULP = 1.2e-7


def gradient_floor(inputs: dict, outdir, one: dict, seeds=(5, 6), **layout) -> dict[str, float]:
    """Each gradient's float32 noise floor, relative to its max-abs: how
    far one rank's first-step gradient moves (the most over ``seeds``) when
    ~1 ulp of seeded noise is put where a split's sums round: the outputs
    of the split modules (attention, whose ring sums its chunks in another
    order, feed-forward, time embedding) and the gradients of their inputs
    (``layout``: the one-rank reference's :func:`acoustic_trainer` keys)."""
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.nn.embeddings import TimePositionalEmbedding
    from isp_tts_tpu_torch.nn.feedforward import FeedForward

    floor = {k: 0.0 for k in one if k.startswith("g::")}
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        originals = {}
        for cls in (Attention, FeedForward, TimePositionalEmbedding):
            def nudged(self, x, *args, _forward=cls.forward, **kwargs):
                out = _forward(self, _NudgeGrad.apply(x, gen), *args, **kwargs)
                return out * (1 + ULP * torch.randn(out.shape, generator=gen))

            originals[cls], cls.forward = cls.forward, nudged
        try:
            moved = case_steps(inputs, outdir, model_axis=1, steps=1, **layout)
        finally:
            for cls, forward in originals.items():
                cls.forward = forward
        for k in floor:
            rel = float(np.abs(moved[k] - one[k]).max() / max(np.abs(one[k]).max(), 1e-12))
            floor[k] = max(floor[k], rel)
    return floor


#: PAR with the aligner's masked batch norm (``normalization: batch``)
PAR_BN = dict(PAR, aligner=dict(PAR["aligner"], normalization="batch"))


def case_batch_norm(inputs: dict, outdir) -> dict:
    """Two micro-steps of PAR_BN (weights ``wb::``) with live dropout on the
    global batch: each step's metrics and every batch norm's running
    statistics after it (``s::``), and the first step's gradients."""
    tr = acoustic_trainer(_part(inputs, "wb"), outdir, 1, model=PAR_BN)
    batch = _batch(inputs)
    out = {}
    for i in range(2):
        for k, v in tr.train(batches=[batch], steps=1)[0].items():
            out.setdefault(f"m::{k}", []).append(v)
        for name, buf in tr.model.named_buffers():
            if name.endswith((".norm.mean", ".norm.var")):
                out.setdefault(f"s::{name}", []).append(buf.numpy().copy())
        if i == 0:
            grads = {f"g::{k}": v for k, v in _full_grads(tr).items()}
    return {**{k: np.asarray(v) for k, v in out.items()}, **grads}


def case_accumulate(inputs: dict, outdir, model_axis: int) -> dict:
    """Gradient accumulation over 2 micro-steps with part of the model
    frozen: 3 micro-steps (the third after the update); each one's loss
    terms and every parameter after them (split ones gathered)."""
    tr = acoustic_trainer(_flat(inputs), outdir, model_axis,
                          optimization={"grad_accum_steps": 2},
                          finetune_layers=["decoder", "temporal_adaptor.predictor"])
    batch = _batch(inputs)
    out = {}
    for _ in range(3):
        for k, v in tr.train(batches=[batch], steps=1)[0].items():
            out.setdefault(f"m::{k}", []).append(v)
    out = {k: np.asarray(v) for k, v in out.items()}
    from isp_tts_tpu_torch.parallel.mesh import full_parameters

    with full_parameters(tr.model, tr.parallel_ctx):
        out.update({f"p::{k}": v.detach().numpy().copy()
                    for k, v in tr.model.named_parameters()})
    return out


def case_jax_step(inputs: dict, outdir, model_axis: int, **layout) -> dict:
    """One step without dropout, with the flow draws of the inputs (JAX's
    draws from its key): the loss terms and the gradient norm, averaged
    over the data ranks."""
    from isp_tts_tpu_torch.parallel.mesh import shard_batch

    tr = acoustic_trainer(_flat(inputs, layout), outdir, model_axis, dropout=False, **layout)
    draws = shard_batch({"x0": inputs["x0"], "t": inputs["t"]}, tr.parallel_ctx)
    metrics = tr.train_step(shard_batch(_batch(inputs), tr.parallel_ctx),
                            noise=torch.from_numpy(draws["x0"]),
                            t=torch.from_numpy(draws["t"]))
    return {f"m::{k}": np.asarray(float(v)) for k, v in metrics.items()}


def case_data_metrics(inputs: dict, outdir) -> dict:
    """The logged readings the data split once averaged over the ranks:
    one micro-step of an accumulation of 2 without dropout, with the
    inputs' flow draws (its ``stats/grad_norm``), then an evaluation step
    and the evaluator's metrics over the data group."""
    from isp_tts_tpu_torch.models.acoustic.evaluator import AcousticModelEvaluator
    from isp_tts_tpu_torch.parallel.context import activated
    from isp_tts_tpu_torch.parallel.mesh import all_reduce_mean, shard_batch

    tr = acoustic_trainer(_flat(inputs), outdir, 1, dropout=False,
                          optimization={"grad_accum_steps": 2})
    draws = shard_batch({"x0": inputs["x0"], "t": inputs["t"]}, tr.parallel_ctx)
    batch = shard_batch(_batch(inputs), tr.parallel_ctx)
    noise, t = torch.from_numpy(draws["x0"]), torch.from_numpy(draws["t"])
    metrics = tr.train_step(batch, noise=noise, t=t)
    out = {f"m::{k}": np.asarray(float(v)) for k, v in metrics.items()}
    outputs, _ = tr.eval_step(batch, noise=noise, t=t)
    with activated(tr.parallel_ctx):
        inputs_ = tr.model.prepare_inputs(tr._to_device(batch))
        evals = all_reduce_mean(AcousticModelEvaluator()(inputs_, outputs), tr.parallel_ctx)
    out.update({f"e::{k}": np.asarray(float(v)) for k, v in evals.items()})
    return out


def gan_overrides(root, outdir) -> dict:
    """``vocoder/vocos`` at the JAX vocoder tests' tiny widths on the toy
    set at ``root``, float32 (either package's recipe overrides)."""
    return {"dataset": {"root": str(root), "segment_samples": 1024},
            "model": {"features": {"sample_rate": 22050, "n_fft": 256, "hop_length": 64,
                                   "win_length": 256, "n_mels": 20, "f_min": 0.0,
                                   "f_max": 8000.0},
                      "generator": {"dim": 32, "intermediate_dim": 64, "num_layers": 2},
                      "discriminator": {"periods": [2, 3],
                                        "resolutions": [[256, 64], [512, 128]],
                                        "mpd_channels": [4, 8], "mrd_channels": 4}},
            "trainer": {"output_dir": str(outdir), "experiment_name": "gan", "label": "run",
                        "epochs": 1, "batch_size": 4, "eval_batch_size": 4,
                        "eval_strategy": "no", "save_strategy": "no", "logging_steps": 1,
                        "progress": False, "log_with": [], "precision": "fp32",
                        "callbacks": {}}}


def gan_trainer(root, outdir):
    """The port's GANTrainer of :func:`gan_overrides` on the CPU."""
    from isp_tts_tpu_torch.training.experiment import ExperimentModules

    return ExperimentModules("vocoder/vocos", "recipes", overrides=gan_overrides(root, outdir),
                             device="cpu").init_modules().build_trainer()


def case_gan(inputs: dict, outdir, model_axis: int = 1) -> dict:
    """One GAN step on the global batch: the metrics and every parameter
    after the update (JAX names)."""
    from isp_tts_tpu_torch.parallel.mesh import shard_batch

    tr = gan_trainer(str(inputs["gan_root"]), outdir)
    tr.model.load_jax_state(_part(inputs, "gw"))
    batch = _part(inputs, "gb")
    tr._set_lr(tr.schedule(0, 0))
    metrics, _ = tr._update(shard_batch(batch, tr.parallel_ctx))
    out = {f"m::{k}": np.asarray(float(v)) for k, v in metrics.items()}
    out.update({f"p::{k}": v for k, v in tr.model.jax_state().items()})
    return out


#: the seq and stage layouts of the cases (their one-rank references ring
#: alone on a size-1 axis, and run the stacked decoder locally)
SEQ = {"model": with_ring(PAR), "mesh_seq_axis": 2}
STAGE = {"model": PAR_STAGE, "mesh_pipeline_axis": 2, "pipeline_microbatches": 2}
SEQ_STAGE = {"model": with_ring(PAR_STAGE), "mesh_seq_axis": 2, "mesh_pipeline_axis": 2,
             "pipeline_microbatches": 2}
#: the seeds of the float32 floor of the stage-split cases' gradients: their
#: ALiBi slope gradients (sums with cancellation) read floors 5-10x apart
#: between seed pairs, so the floor is the most over six draws
STAGE_FLOOR_SEEDS = tuple(range(5, 11))
#: data × seq 2 × stage 2 (data 2 on 8 ranks): the composed step of the
#: JAX package's ``_run_composed_train_phase``, the encoder ringing over
#: "seq", the stacked decoder over "stage"
COMPOSED = dict(SEQ_STAGE, model=with_ring(PAR_STAGE, parts=("encoder",)))


def one_rank(layout: dict) -> dict:
    """``layout`` with its axes at 1: the one-rank reference's keys."""
    out = {k: v for k, v in layout.items() if not k.startswith("mesh_")}
    if "mesh_seq_axis" in layout:
        out["ring_alone"] = True
    return out


CASES = {
    "data": lambda inputs, out: case_steps(inputs, out, model_axis=1),
    "seq": lambda inputs, out: case_steps(inputs, out, model_axis=1, **SEQ),
    "stage": lambda inputs, out: case_steps(inputs, out, model_axis=1, **STAGE),
    "seq_stage": lambda inputs, out: case_steps(inputs, out, model_axis=1, **SEQ_STAGE),
    "seq_jax": lambda inputs, out: case_jax_step(inputs, out, model_axis=1, **SEQ),
    "stage_jax": lambda inputs, out: case_jax_step(inputs, out, model_axis=1, **STAGE),
    "model_stage": lambda inputs, out: case_steps(inputs, out, model_axis=2, **STAGE),
    "model_stage_jax": lambda inputs, out: case_jax_step(inputs, out, model_axis=2, **STAGE),
    "composed": lambda inputs, out: case_steps(inputs, out, model_axis=1, **COMPOSED),
    "composed_jax": lambda inputs, out: case_jax_step(inputs, out, model_axis=1, **COMPOSED),
    "data_metrics": case_data_metrics,
    "batch_norm": case_batch_norm,
    "model": lambda inputs, out: case_steps(inputs, out, model_axis=2),
    "accumulate": lambda inputs, out: case_accumulate(inputs, out, model_axis=2),
    "data_model": lambda inputs, out: case_steps(inputs, out, model_axis=2),
    "jax_step": lambda inputs, out: case_jax_step(inputs, out, model_axis=2),
    "gan": case_gan,
}


def one_thread(fn, *args, **kwargs):
    """``fn`` with one intra-op thread, as the ranks run (the sums' order
    then does not hang on the host's core count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.random.fork_rng():
            return fn(*args, **kwargs)
    finally:
        torch.set_num_threads(n)


def _part(inputs: dict, prefix: str) -> dict:
    """The entries ``prefix::name`` of the inputs, by name."""
    return {k.split("::", 1)[1]: v for k, v in inputs.items() if k.startswith(prefix + "::")}


def _flat(inputs: dict, layout: dict | None = None) -> dict:
    """The weights of the case's model: ``ws::`` (PAR_STAGE's per-layer
    twin, JAX names) for a stacked decoder, else ``w::`` (PAR)."""
    stacked = bool(layout) and layout.get("model", {}).get("decoder", {}).get("pipeline")
    return _part(inputs, "ws" if stacked else "w")


def _batch(inputs: dict) -> dict:
    return _part(inputs, "b")


def save_inputs(path, weights: dict, batch: dict, **more) -> None:
    """The parent's inputs for the ranks, in one ``.npz``."""
    arrays = {f"w::{k}": v for k, v in weights.items()}
    arrays.update({f"b::{k}": v for k, v in batch.items() if isinstance(v, np.ndarray)})
    for key, value in more.items():
        if isinstance(value, dict):
            arrays.update({f"{key}::{k}": np.asarray(v) for k, v in value.items()
                           if isinstance(v, (np.ndarray, np.generic))})
        else:
            arrays[key] = np.asarray(value)
    np.savez(path, **arrays)


def spawn(world: int, inputs, out, cases: list[str], tmp) -> list[subprocess.Popen]:
    """Start ``world`` ranks on a fresh ``file://`` store under ``tmp``."""
    store = Path(tmp) / f"store_{time.monotonic_ns()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = []
    for rank in range(world):
        log = open(Path(tmp) / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(rank), "--world", str(world),
             "--store", str(store), "--inputs", str(inputs), "--out", str(out),
             "--cases", ",".join(cases)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs: list[subprocess.Popen], tmp, timeout: float = 120.0) -> None:
    """Wait for every rank, at most ``timeout`` seconds in all; kill the
    rest and raise with the ranks' logs on a deadline or a failure."""
    deadline = time.monotonic() + timeout
    failed = []
    for rank, proc in enumerate(procs):
        try:
            code = proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            code = "timeout"
        if code != 0:
            failed.append((rank, code))
    if failed:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        logs = "\n".join(f"--- rank {r} ---\n" + (Path(tmp) / f"rank{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        raise AssertionError(f"ranks failed {failed}:\n{logs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from isp_tts_tpu_torch.parallel.mesh import init_distributed

    init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                     rank=args.rank, timeout_s=60)
    try:
        inputs = dict(np.load(args.inputs, allow_pickle=False))
        for case in args.cases.split(","):
            result = CASES[case](inputs, Path(args.out) / f"run_{case}_{args.rank}")
            if args.rank == 0:
                np.savez(Path(args.out) / f"{case}.npz", **result)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
