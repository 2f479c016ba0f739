"""The GANTrainer across the two packages, on the CPU, float32.

Tiny widths of ``recipes/vocoder/vocos.yaml`` (the JAX vocoder tests'
TINY_MODEL) on a toy set of WAVs, both trainers built from the recipe:

- one whole GAN step (AdamW with the recipe's betas, clip 1.0) of the
  port's trainer against the JAX GANTrainer's jitted ``train_step`` on the
  same batch, from the same parameters: the seven metrics within 1e-5
  relative, every updated parameter (both branches) within 1e-5 absolute,
  and the optimizers' tree paths JAX's; again with ``finetune_layers``
  freezing part of each branch;
- a JAX GANTrainer checkpoint resumed by the port, and a port checkpoint
  resumed by JAX: step, learning rate, both optimizers' moments (under
  ``['gen']`` and ``['disc']``) and the parameters exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isp_tts_tpu.training.experiment import ExperimentModules as JExperimentModules
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.training.experiment import ExperimentModules
from isp_tts_tpu_torch.training.gan_trainer import GANTrainer
from test_torch_port_gan import TINY_MODEL
from torch_port_common import jax_flat, write_toy_dataset

METRICS = ("loss", "losses/disc", "losses/gen_adv", "losses/feature_matching", "losses/mel",
           "stats/grad_norm", "stats/grad_norm_disc")


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_gan")
    write_toy_dataset(root)
    return root


def overrides(root, outdir, **trainer):
    return {"dataset": {"root": str(root), "segment_samples": 1024},
            "model": TINY_MODEL,
            "trainer": dict({"output_dir": str(outdir), "experiment_name": "gan",
                             "label": "run", "epochs": 1, "batch_size": 4,
                             "eval_batch_size": 4, "eval_strategy": "no",
                             "save_strategy": "no", "logging_steps": 1, "progress": False,
                             "log_with": [], "precision": "fp32", "callbacks": {}},
                            **trainer)}


def port_trainer(root, outdir, **trainer):
    return ExperimentModules("vocoder/vocos", "recipes", overrides=overrides(root, outdir, **trainer),
                             device="cpu").init_modules().build_trainer()


def jax_trainer(root, outdir, **trainer):
    modules = JExperimentModules("vocoder/vocos", "recipes",
                                 overrides=overrides(root, outdir, num_devices=1, **trainer))
    modules.init_modules()
    return modules.build_trainer()


@pytest.mark.parametrize("finetune", [None, ["generator.head", "discriminator.resolution_discs"]])
def test_one_gan_step_matches_jax(toy_root, tmp_path, finetune):
    """With ``finetune_layers`` each branch's freeze mask is matched against
    the full names of its parameters (the frozen ones do not move)."""
    jt = jax_trainer(toy_root, tmp_path / "j", finetune_layers=finetune)
    pt = port_trainer(toy_root, tmp_path / "p", finetune_layers=finetune)
    before = jax_flat(jt.model)
    assert isinstance(pt, GANTrainer)
    pt.model.load_jax_state(jax_flat(jt.model))
    batch = next(iter(pt.train_loader))
    lr = pt.schedule(0, 0)
    assert lr == jt.schedule(0, 0)
    pt._set_lr(lr)
    got, emitted = pt._update(batch)
    assert emitted

    jt.opt_state = jt._apply_lr(lr)
    jt._build_steps()
    fn = jt._step_for_mode("train")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    jt.opt_state, ref = fn(jt.opt_state, jbatch, jnp.asarray(0, jnp.int32))
    for k in METRICS:
        a, b = float(got[k]), float(ref[k])
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-6), (k, a, b)
    after = jax_flat(jt.model)
    ours = pt.model.jax_state()
    assert set(ours) == set(after)
    for k, v in after.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-5, err_msg=k)
        if finetune and not k.startswith(tuple(finetune)):
            np.testing.assert_array_equal(ours[k], before[k], err_msg=k)
    paths, _ = jax.tree_util.tree_flatten_with_path(jt.opt_state)
    assert set(pt.optimizer_keyed_state()) == {jax.tree_util.keystr(p) for p, _ in paths}


def _keyed_jax(jt) -> dict:
    paths, _ = jax.tree_util.tree_flatten_with_path(jt.opt_state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


def _same_state(pt, jt):
    assert pt.state.global_step == jt.state.global_step == 2
    assert pt.state.learning_rate == jt.state.learning_rate
    got, ref = pt.optimizer_keyed_state(), _keyed_jax(jt)
    assert set(got) == set(ref)
    assert any(k.startswith("['gen']") and ".mu[" in k for k in got)
    assert any(k.startswith("['disc']") and ".nu[" in k for k in got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in jax_flat(jt.model).items():
        np.testing.assert_array_equal(pt.model.jax_state()[k], v, err_msg=k)


def test_gan_checkpoints_resume_across_packages(toy_root, tmp_path):
    # JAX writes, the port resumes
    jt = jax_trainer(toy_root, tmp_path / "j", max_steps=2)
    jt.train()
    ckpt = jt.run_dir / "checkpoint_last.ckpt"
    pt = port_trainer(toy_root, tmp_path / "p1", resume_from_checkpoint=str(ckpt),
                      warm_start=False)
    _same_state(pt, jt)

    # the port writes, JAX resumes
    pt2 = port_trainer(toy_root, tmp_path / "p2", max_steps=2)
    pt2.train()
    ckpt2 = pt2.run_dir / "checkpoint_last.ckpt"
    assert load_checkpoint(ckpt2)["model"]["class"] == "VocoderModel"
    jt2 = jax_trainer(toy_root, tmp_path / "j2", resume_from_checkpoint=str(ckpt2),
                      warm_start=False)
    _same_state(pt2, jt2)
