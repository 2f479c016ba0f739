"""``--distributed`` training through the CLI under ``torch.distributed.run``
on the CPU (gloo), against the JAX package's checkpoint reader.

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
isp_tts_tpu_torch.train --distributed --device cpu`` on the toy set for 2
steps (``--standalone`` picks a free local port, so runs side by side do
not meet; the run has a deadline of its own): rank 0 alone writes the one
checkpoint and the resolved recipe, the JAX package loads the checkpoint's
model, and a one-rank resume of it continues to step 3.
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


def cli_args(root, outdir) -> list[str]:
    """The same overrides as ``--set`` flags (JSON is YAML flow)."""
    args = ["--config-name", "acoustic/core", "--device", "cpu"]
    for key, value in overrides(root, outdir, max_steps=2).items():
        args += ["--set", f"{key}={json.dumps(value)}"]
    return args


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    root = tmp / "toy"
    write_toy_dataset(root)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "isp_tts_tpu_torch.train", "--distributed",
         *cli_args(root, tmp / "runs")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, tmp / "runs" / "e2e" / "dist", proc


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
