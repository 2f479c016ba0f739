"""The port's trainer from a recipe, on the CPU: the port's versions of
``tests/test_train_e2e.py`` and ``tests/test_trainer_fixes.py`` (evaluation,
saving, best-metric tracking, full resume and warm start with the freeze
mask, step accounting under gradient accumulation, the profiler window,
eval mode, chunked steps equal to per-step ones, ``restore_lr``, the
sidecar resume, the path-keyed optimizer, the non-finite accumulator),
plus a resumed run that reproduces the uninterrupted one. The toy set
and the tiny recipe model of the JAX tests (head dim 64, dropout off),
float32.
"""

import logging

import numpy as np
import pytest
import torch

from isp_tts_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from isp_tts_tpu_torch.config import merge_dicts
from isp_tts_tpu_torch.training.experiment import ExperimentModules
from isp_tts_tpu_torch.training.trainer import Accumulator
from torch_port_common import toy_overrides, write_toy_dataset


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_e2e")
    write_toy_dataset(root)
    return root


def build(root, outdir, model_over=None, collator_over=None, **trainer_over):
    over = toy_overrides(root, outdir, **trainer_over)
    over["model"] = merge_dicts(over["model"], model_over or {})
    over["collator"] = {**over["collator"], **(collator_over or {})}
    return ExperimentModules("acoustic/core", "recipes", overrides=over,
                             device="cpu").init_modules().build_trainer()


def losses(trainer):
    return [h["train_step/loss"] for h in trainer.state.log_history if "train_step/loss" in h]


def test_train_eval_checkpoint_resume(toy_root, tmp_path):
    trainer = build(toy_root, tmp_path, epochs=2, batch_size=8, eval_batch_size=8,
                    save_strategy="epoch", eval_strategy="epoch", eval_batches=1)
    trainer.train()
    assert trainer.state.global_step == 2
    run_dir = trainer.run_dir
    for name in ("checkpoint_last.ckpt", "checkpoint_best.ckpt", "trainer_state.json",
                 "config.yaml", "checkpoint_e0.ckpt", "checkpoint_e1.ckpt"):
        assert (run_dir / name).exists(), name
    assert losses(trainer) and np.isfinite(losses(trainer)[-1])
    evals = [h for h in trainer.state.log_history if "eval/loss" in h]
    assert len(evals) == 2 and "eval/metrics/mcd_13" in evals[-1]
    assert "eval/metrics/alignment_length" in evals[-1]
    assert all(isinstance(v, (int, float)) for h in evals for v in h.values())

    resumed = build(toy_root, tmp_path, epochs=3, batch_size=8,
                    resume_from_checkpoint=str(run_dir / "checkpoint_last.ckpt"))
    assert resumed.state.global_step == 2 and resumed.optimizer.count == 2
    resumed.train()
    assert resumed.state.global_step == 3

    warm = build(toy_root, tmp_path, batch_size=8, warm_start=True,
                 resume_from_checkpoint=str(run_dir / "checkpoint_last.ckpt"),
                 finetune_layers=["decoder", "to_mel"])
    assert warm.state.global_step == 0 and warm.model.frozen_prefixes
    before = {k: v.clone() for k, v in warm.model.state_dict().items()}
    warm.train()
    after = warm.model.state_dict()
    assert torch.equal(before["encoder.layers.0.attention.to_q.weight"],
                       after["encoder.layers.0.attention.to_q.weight"])
    assert not torch.equal(before["decoder.layers.0.attention.to_q.weight"],
                           after["decoder.layers.0.attention.to_q.weight"])
    keyed = warm.optimizer.keyed_state()
    assert any("['decoder']" in k for k in keyed)
    assert not any("['encoder']" in k for k in keyed)  # frozen: no moments


def test_from_pretrained_of_trainer_checkpoint(toy_root, tmp_path):
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel

    trainer = build(toy_root, tmp_path, save_strategy="epoch")
    trainer.train()
    model = AcousticModel.from_pretrained(trainer.run_dir / "checkpoint_last.ckpt",
                                          device="cpu")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v.cpu()), k
    mel, _ = model.infer(torch.tensor([[2, 3, 4, 1]]), max_dec_len=32, steps=2)
    assert mel.shape == (1, 32, 80) and torch.isfinite(mel).all()


def test_grad_accumulation_step_accounting(toy_root, tmp_path):
    """8 samples / batch 2 / accumulation 2: two optimizer steps an epoch."""
    trainer = build(toy_root, tmp_path, epochs=2, batch_size=2,
                    optimization={"learning_rate": 1e-4, "grad_accum_steps": 2})
    trainer.train()
    assert trainer.state.global_step == 4 and trainer._micro_step == 8
    assert trainer.optimizer.count == 4 and trainer.optimizer.mini_step == 0


def test_profiler_trace_window(toy_root, tmp_path):
    trainer = build(toy_root, tmp_path, epochs=2, profile_steps=(1, 2))
    trainer.train()
    traces = list((trainer.run_dir / "profile").glob("*.json"))
    assert traces and traces[0].stat().st_size > 0


def test_eval_mode_runs_single_evaluation_without_training(toy_root, tmp_path):
    trainer = build(toy_root, tmp_path, eval_mode=True, eval_batches=1)
    assert trainer.config.do_train is False
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    metrics = trainer.train()
    assert np.isfinite(metrics["eval/loss"]) and "eval/metrics/mcd_13" in metrics
    assert trainer.state.global_step == 0
    assert not (trainer.run_dir / "checkpoint_last.ckpt").exists()
    assert not (trainer.run_dir / "checkpoint_best.ckpt").exists()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(before[k], v), k
    modules = ExperimentModules("acoustic/core", "recipes", device="cpu",
                                overrides=toy_overrides(toy_root, tmp_path))
    adhoc = trainer.evaluate(eval_dataset=modules.build_dataset("eval"))
    assert np.isfinite(adhoc["eval/loss"])


def test_chunked_training_matches_per_step(toy_root, tmp_path):
    """steps_per_call 2 gives the per-step path's losses exactly (the same
    steps, run back to back); a tail shorter than K runs per step and never
    passes max_steps."""
    kw = dict(epochs=2, collator_over={"fixed_shape": True},
              model_over={"encoder": {"transformer_layer": {"attention": {"dropout": 0.1}}}})
    ref = build(toy_root, tmp_path / "per_step", **kw)
    ref.train()
    chunk = build(toy_root, tmp_path / "chunked", steps_per_call=2, **kw)
    chunk.train()
    assert chunk.state.global_step == ref.state.global_step == 4
    np.testing.assert_array_equal(losses(chunk), losses(ref))
    tail = build(toy_root, tmp_path / "tail", steps_per_call=4, max_steps=3, **kw)
    tail.train()
    assert tail.state.global_step == 3
    np.testing.assert_array_equal(losses(tail), losses(ref)[:3])


def test_resumed_run_reproduces_the_uninterrupted_one(toy_root, tmp_path):
    """Two epochs of two steps with dropout on, saved at step 1 (mid-epoch)
    and resumed in a fresh trainer: steps 2-4 give the uninterrupted run's
    losses and final weights exactly."""
    kw = dict(epochs=2, save_strategy="steps", save_steps=1,
              model_over={"encoder": {"transformer_layer": {"attention": {"dropout": 0.1},
                                                            "feed_forward": {"dropout": 0.2}}}})
    full = build(toy_root, tmp_path / "full", **kw)
    full.train()
    ckpt = full.run_dir / "checkpoint_s1.ckpt"
    resumed = build(toy_root, tmp_path / "resumed", resume_from_checkpoint=str(ckpt), **kw)
    assert (resumed.state.global_step, resumed.state.epoch_step) == (1, 1)
    resumed.train()
    assert resumed.state.global_step == 4
    # the restored log history holds step 1; steps 2-4 are the resumed run's
    np.testing.assert_array_equal(losses(resumed), losses(full))
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


@pytest.fixture(scope="module")
def trained_run(toy_root, tmp_path_factory):
    trainer = build(toy_root, tmp_path_factory.mktemp("port_run"), batch_size=8)
    trainer.train()
    return trainer.run_dir


def test_restore_lr(toy_root, trained_run):
    ckpt = str(trained_run / "checkpoint_last.ckpt")

    def resume(**kw):
        return build(toy_root, trained_run.parent, resume_from_checkpoint=ckpt,
                     optimization={"learning_rate": 9e-5}, **kw)

    assert resume(restore_lr=True).schedule.base_lr == pytest.approx(2e-4)
    assert resume(restore_lr=False).schedule.base_lr == pytest.approx(9e-5)


def test_resume_from_sidecar_trainer_state(toy_root, trained_run):
    payload = load_checkpoint(trained_run / "checkpoint_last.ckpt")
    payload["experiment"].pop("state")
    stripped = trained_run / "checkpoint_stripped.ckpt"
    save_checkpoint(stripped, payload)
    assert (trained_run / "trainer_state.json").exists()
    trainer = build(toy_root, trained_run.parent, epochs=2,
                    resume_from_checkpoint=str(stripped))
    assert trainer.state.global_step == 1


def test_optimizer_checkpoint_is_path_keyed(toy_root, trained_run):
    """A reordered keyed dict restores the same state; a renamed key raises."""
    src = trained_run / "checkpoint_last.ckpt"
    payload = load_checkpoint(src)
    keyed = payload["optimizer"]["keyed"]
    assert all(k.startswith((".", "[")) for k in keyed) and len(keyed) > 2

    def resume(path):
        return build(toy_root, trained_run.parent, resume_from_checkpoint=str(path))

    baseline = resume(src).optimizer.keyed_state()
    reordered = trained_run / "ckpt_reordered.ckpt"
    payload["optimizer"]["keyed"] = dict(reversed(list(keyed.items())))
    save_checkpoint(reordered, payload)
    got = resume(reordered).optimizer.keyed_state()
    assert list(got) == list(baseline)
    for k in baseline:
        np.testing.assert_array_equal(got[k], baseline[k])
    mutated = dict(keyed)
    k0 = next(iter(mutated))
    mutated["[999].bogus" + k0] = mutated.pop(k0)
    payload["optimizer"]["keyed"] = mutated
    bad = trained_run / "ckpt_badkey.ckpt"
    save_checkpoint(bad, payload)
    with pytest.raises(ValueError, match="missing keys"):
        resume(bad)


def test_accumulator_surfaces_nonfinite(caplog):
    acc = Accumulator()
    for v in (1.0, float("nan"), torch.tensor(3.0)):
        acc.add({"loss": v})
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        means = acc.means()
    assert means["loss"] == pytest.approx(2.0) and means["stats/nonfinite"] == 1.0
    assert any("non-finite" in r.message for r in caplog.records)
    acc.add({"loss": float("inf")})
    assert acc.means()["stats/nonfinite"] == 2.0
    assert acc.means()["stats/nonfinite"] == 2.0
    acc.reset()
    acc.add({"loss": 1.0})
    assert "stats/nonfinite" not in acc.means()


def test_train_cli_runs_and_computes_stats(toy_root, tmp_path):
    """``python -m isp_tts_tpu_torch.train`` with ``--set`` overrides and
    ``--device cpu``: ``--compute-stats`` writes stats.json, then a one-step
    run writes its checkpoint and the resolved recipe."""
    import json
    import shutil

    from isp_tts_tpu_torch import train

    root = tmp_path / "data"
    shutil.copytree(toy_root, root)
    args = ["--config-name", "acoustic/core", "--device", "cpu",
            "--set", f"dataset.root={root}", "--set", "model.text_dim=16",
            "--set", "model.encoder={dim: 16, depth: 1, transformer_layer: {attention: "
                     "{heads: 2, head_dim: 64, dropout: 0.0}, feed_forward: {inner_dim: 32}}}",
            "--set", "model.decoder=${model.encoder}",
            "--set", "model.temporal_adaptor.predictor.transformer={dim: 16, depth: 1}",
            "--set", "model.temporal_adaptor.embedding.transformer={dim: 16, depth: 1}",
            "--set", f"trainer.output_dir={tmp_path / 'runs'}", "--set", "trainer.label=cli",
            "--set", "trainer.max_steps=1", "--set", "trainer.batch_size=4",
            "--set", "trainer.precision=fp32", "--set", "trainer.log_with=[]",
            "--set", "trainer.progress=no"]
    train.main(args + ["--compute-stats"])
    stats = json.loads((root / "stats.json").read_text())
    assert 40.0 < stats["pitch"]["mean"] < 800.0
    train.main(args)
    run = tmp_path / "runs" / "AcousticModel" / "cli"
    assert (run / "checkpoint_last.ckpt").exists() and (run / "config.yaml").exists()
    assert load_checkpoint(run / "checkpoint_last.ckpt")["experiment"]["state"][
        "global_step"] == 1


def test_tracker_warns_and_stays_off_without_its_backends(monkeypatch, caplog):
    """The tracker, as JAX's: tensorboard or wandb missing is a warning and
    a disabled backend, never an error."""
    import builtins

    from isp_tts_tpu_torch.training.callbacks import TrackerCallback, TrainerState
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name in ("torch.utils.tensorboard", "wandb"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    tracker = TrackerCallback("unused")
    cfg = TrainerConfig(log_with=("tensorboard", "wandb"))
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        tracker.on_train_begin(cfg, TrainerState(), None)
        tracker.on_log(cfg, TrainerState(), None, logs={"loss": 1.0})
        tracker.on_train_end(cfg, TrainerState(), None)
    assert tracker.writer is None and tracker.wandb is None
    assert sum("unavailable" in r.message or "not installed" in r.message
               for r in caplog.records) == 2


def test_epoch_seed_callback_reseeds_the_host_and_torch():
    import random

    from isp_tts_tpu_torch.training.callbacks import (EpochReproducibilityCallback,
                                                      TrainerState)
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    cb, cfg = EpochReproducibilityCallback(), TrainerConfig(seed=5)
    draws = []
    for _ in range(2):
        cb.on_epoch_begin(cfg, TrainerState(epoch=2.0), None)
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]
    random.seed(15)
    np.random.seed(15)
    assert draws[0][:2] == (random.random(), np.random.rand())
