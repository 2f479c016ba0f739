"""``--distributed`` training through the CLI under ``torch.distributed.run``
on the CPU (gloo), against the JAX package's checkpoint reader.

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
isp_tts_tpu_torch.train --distributed --device cpu`` on the toy set for 2
steps (``--standalone`` picks a free local port, so runs side by side do
not meet; the run has a deadline of its own): rank 0 alone writes the one
checkpoint and the resolved recipe, the JAX package loads the checkpoint's
model, and a one-rank resume of it continues to step 3. Then
``acoustic/core_pp`` the same way over 2 stages (the toy model's decoder
stacked, 2 layers, 2 microbatches): rank 0 writes one checkpoint holding
the global stacked decoder and both stages' optimizer moments; the JAX
package loads it into its ``pipeline: true`` model and into its per-layer
model bit-equal, the port's per-layer ``acoustic/core`` warm-starts from
it, and a one-rank resume of ``core_pp`` (the stacked decoder run
locally) continues to step 3.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from isp_tts_tpu.models.acoustic.model import AcousticModel as JAcousticModel
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.training.experiment import ExperimentModules
from torch_port_common import toy_overrides, write_toy_dataset

ROOT = Path(__file__).resolve().parent.parent


def overrides(root, outdir, **trainer) -> dict:
    """The toy recipe overrides with attention and feed-forward dropout 0.1."""
    over = toy_overrides(root, outdir, label="dist", **trainer)
    layer = over["model"]["encoder"]["transformer_layer"]
    over["model"]["encoder"]["transformer_layer"] = {
        "attention": dict(layer["attention"], dropout=0.1),
        "feed_forward": dict(layer["feed_forward"], dropout=0.1)}
    return over


def pp_overrides(root, outdir, **trainer) -> dict:
    """The toy overrides with the decoder stacked, 2 layers, 2 microbatches."""
    over = toy_overrides(root, outdir, label="pp", pipeline_microbatches=2, **trainer)
    over["model"] = dict(over["model"], decoder=dict(over["model"]["encoder"], depth=2,
                                                     pipeline=True))
    return over


def cli_args(root, outdir, recipe="acoustic/core", over=None) -> list[str]:
    """The same overrides as ``--set`` flags (JSON is YAML flow)."""
    args = ["--config-name", recipe, "--device", "cpu"]
    for key, value in (over or overrides(root, outdir, max_steps=2)).items():
        args += ["--set", f"{key}={json.dumps(value)}"]
    return args


def torchrun(args: list[str]):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "isp_tts_tpu_torch.train", "--distributed", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    root = tmp / "toy"
    write_toy_dataset(root)
    proc = torchrun(cli_args(root, tmp / "runs"))
    return root, tmp / "runs" / "e2e" / "dist", proc


@pytest.fixture(scope="module")
def run_pp(run):
    root, dist_dir, _ = run
    outdir = dist_dir.parent.parent.parent / "runs_pp"
    proc = torchrun(cli_args(root, outdir, "acoustic/core_pp",
                             pp_overrides(root, outdir, max_steps=2)))
    return root, outdir / "e2e" / "pp", proc


def test_rank_0_alone_writes_one_checkpoint(run):
    _, run_dir, proc = run
    assert sorted(p.name for p in run_dir.glob("*.ckpt")) == ["checkpoint_last.ckpt"]
    assert (run_dir / "config.yaml").exists()
    ckpt = load_checkpoint(run_dir / "checkpoint_last.ckpt")
    assert ckpt["experiment"]["state"]["global_step"] == 2
    # both ranks trained: each logged its place in the mesh
    assert "rank 0 of 2: data 0/2" in proc.stderr and "rank 1 of 2: data 1/2" in proc.stderr


def test_the_jax_package_loads_the_checkpoint(run):
    _, run_dir, _ = run
    jm = JAcousticModel.from_pretrained(str(run_dir / "checkpoint_last.ckpt"))
    ours = load_checkpoint(run_dir / "checkpoint_last.ckpt")["model"]["state"]
    theirs = jm.state_dict()
    assert set(theirs) <= set(ours)
    for k, v in theirs.items():
        np.testing.assert_allclose(np.asarray(v, np.float32), np.asarray(ours[k], np.float32),
                                   rtol=0, atol=0, err_msg=k)


def test_one_rank_resumes_the_checkpoint(run, tmp_path):
    root, run_dir, _ = run
    over = overrides(root, run_dir.parent.parent, max_steps=3,
                     resume_from_checkpoint=str(run_dir / "checkpoint_last.ckpt"))
    trainer = ExperimentModules("acoustic/core", "recipes", overrides=over,
                                device="cpu").init_modules().build_trainer()
    assert trainer.state.global_step == 2
    trainer.train()
    assert trainer.state.global_step == 3
    assert load_checkpoint(run_dir / "checkpoint_last.ckpt")["experiment"]["state"][
        "global_step"] == 3


def test_core_pp_ranks_write_the_global_stacked_checkpoint(run_pp):
    _, run_dir, proc = run_pp
    assert sorted(p.name for p in run_dir.glob("*.ckpt")) == ["checkpoint_last.ckpt"]
    assert "seq 0/1, stage 0/2" in proc.stderr and "seq 0/1, stage 1/2" in proc.stderr
    ckpt = load_checkpoint(run_dir / "checkpoint_last.ckpt")
    state, keyed = ckpt["model"]["state"], ckpt["optimizer"]["keyed"]
    kernel = "decoder.stack.attention.to_q.kernel"
    assert state[kernel].shape == (2, 16, 128)
    mu = [v for k, v in keyed.items() if k.endswith("['decoder']['stack']['attention']"
                                                    "['to_q']['kernel'].value") and ".mu" in k]
    assert len(mu) == 1 and mu[0].shape == (2, 16, 128) and np.abs(mu[0][1]).max() > 0


def test_the_jax_package_loads_the_core_pp_checkpoint_both_ways(run_pp):
    from flax import nnx

    from isp_tts_tpu.config import build_config as jax_build_config
    from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JConfig

    _, run_dir, _ = run_pp
    ours = load_checkpoint(run_dir / "checkpoint_last.ckpt")["model"]
    stacked = JAcousticModel.from_pretrained(str(run_dir / "checkpoint_last.ckpt"))
    for k, v in stacked.state_dict().items():
        assert np.array_equal(np.asarray(v, np.float32), ours["state"][k]), k
    cfg = dict(ours["config"], decoder=dict(ours["config"]["decoder"], pipeline=False))
    per_layer = JAcousticModel(jax_build_config(JConfig, cfg), rngs=nnx.Rngs(0))
    per_layer.load_params(ours["state"])
    got = per_layer.state_dict()
    for i in range(2):
        k = f"decoder.layers.{i}.attention.to_q.kernel"
        assert np.array_equal(got[k], ours["state"]["decoder.stack.attention.to_q.kernel"][i])


def test_the_port_warm_starts_core_from_core_pp_and_resumes_core_pp(run_pp):
    root, run_dir, _ = run_pp
    ckpt = str(run_dir / "checkpoint_last.ckpt")
    stacked = load_checkpoint(ckpt)["model"]["state"]["decoder.stack.feed_forward.fc1.kernel"]
    over = overrides(root, run_dir.parent.parent, max_steps=1, resume_from_checkpoint=ckpt,
                     warm_start=True)
    over["model"] = dict(over["model"], decoder=dict(over["model"]["encoder"], depth=2))
    plain = ExperimentModules("acoustic/core", "recipes", overrides=over,
                              device="cpu").init_modules().build_trainer()
    got = plain.model.jax_state()
    for i in range(2):
        assert np.array_equal(got[f"decoder.layers.{i}.feed_forward.fc1.kernel"], stacked[i])
    resumed = ExperimentModules("acoustic/core_pp", "recipes", overrides=pp_overrides(
        root, run_dir.parent.parent, max_steps=3, resume_from_checkpoint=ckpt,
        mesh_pipeline_axis=1),
        device="cpu").init_modules().build_trainer()
    assert resumed.state.global_step == 2
    resumed.train()
    assert resumed.state.global_step == 3
