"""Four gloo ranks on the CPU, data 2 × model 2, seq 2 × stage 2 and model
2 × stage 2, against one rank and against the JAX trainer's step on the
same mesh.

The ranks (``torch_port_parallel_workers.py``) start once for the module
through a ``file://`` store and run both cases:

- 3 steps of ``PAR`` (float32, live dropout 0.1) against one rank: the
  loss terms and gradient norm of each step within rel 1e-4, the first
  step's gradients within 1e-5 of each tensor's max-abs or twice its
  float32 floor (``test_torch_port_parallel_two.py`` says why);
- one step without dropout, from the JAX model's weights and with the flow
  draws the JAX model makes from its key, against the JAX step's loss over
  ``make_mesh(data=2, model=2)`` of the conftest's virtual CPU devices
  (``shard_params`` by its TP rules, the batch over "data"): every loss
  term within rel 1e-4, the bound of ``test_torch_port_train_step.py``;
- seq 2 × stage 2 (``flash: ring`` in the encoder and the stacked decoder
  of 2 layers, 2 microbatches: each stage's layer rings over its seq
  pair) for 3 steps with live dropout against one rank (ringing alone,
  the stacked decoder locally): loss terms and gradient norm within rel
  1e-4, the first step's gradients within 1e-5 of each tensor's max-abs
  or twice its float32 floor measured on that model;
- model 2 × stage 2 (the stacked decoder of 2 layers over 2 stages, each
  stage's layer split over its 2 model ranks: heads and the GLU's halves,
  2 microbatches) for 3 steps with live dropout against one rank (the
  stacked decoder locally): loss terms and gradient norm within rel 1e-4,
  the first step's gradients (gathered over both groups) within 1e-5 of
  each tensor's max-abs or twice its float32 floor (the most over
  ``STAGE_FLOOR_SEEDS``' six draws); and one step without
  dropout, with JAX's flow draws, against the JAX step on
  ``make_mesh(model=2, stage=2)`` (the stacked tensors sharded over
  "stage" and, one dim further right, over "model"): loss terms and
  gradient norm within rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

import torch_port_parallel_workers as W
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic import loss as jloss
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from test_torch_port_parallel_two import _grads_close, _metrics_close, jax_mesh_step
from torch_port_common import flow_draws, perturb

CASES = ["data_model", "jax_step", "seq_stage", "model_stage", "model_stage_jax"]


def jax_mesh_loss(jm, batch: dict, key) -> dict[str, float]:
    """The JAX model's loss terms over a data 2 × model 2 mesh."""
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    nnx.update(jm, shard_params(nnx.state(jm), mesh))
    inputs = {"text": batch["text_vector"], "text_len": batch["text_vector_len"],
              "mel": batch["mel"], "mel_len": batch["mel_len"], "pitch": batch["pitch"],
              "energy": batch["energy"], "speaker": batch["speaker"]}
    sharded = shard_batch(inputs, mesh)
    crit = jloss.AcousticModelLoss()

    @nnx.jit
    def loss_fn(m, x):
        loss, losses = crit(x, m(**x, key=key), 0)
        return loss, losses

    loss, losses = loss_fn(jm, sharded)
    return {"loss": float(loss), **{k: float(v) for k, v in losses.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks4")
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, W.without_dropout(W.PAR)),
                        rngs=nnx.Rngs(0))
    flat = perturb(jm, 12)
    batch = W.global_batch()
    key = jax.random.PRNGKey(21)
    x0, t = flow_draws(key, *batch["text_vector"].shape)
    jstage = JAcousticModel(jax_build_config(JAcousticModelConfig, W.PAR_STAGE_LAYERS),
                            rngs=nnx.Rngs(1))
    flat_stage = perturb(jstage, 13)
    W.save_inputs(tmp / "inputs.npz", flat, batch, ws=flat_stage, x0=x0, t=t)
    procs = W.spawn(4, tmp / "inputs.npz", tmp, CASES, tmp)
    try:
        inputs = dict(np.load(tmp / "inputs.npz"))
        one = W.one_thread(W.case_steps, inputs, tmp / "one", model_axis=1)
        floor = W.one_thread(W.gradient_floor, inputs, tmp / "floor", one)
        one_seq_stage = W.one_thread(W.case_steps, inputs, tmp / "one_ss", model_axis=1,
                                     **W.one_rank(W.SEQ_STAGE))
        floor_seq_stage = W.one_thread(W.gradient_floor, inputs, tmp / "floor_ss",
                                       one_seq_stage, **W.one_rank(W.SEQ_STAGE))
        one_model_stage = W.one_thread(W.case_steps, inputs, tmp / "one_ms", model_axis=1,
                                       **W.one_rank(W.STAGE))
        floor_model_stage = W.one_thread(W.gradient_floor, inputs, tmp / "floor_ms",
                                         one_model_stage, seeds=W.STAGE_FLOOR_SEEDS,
                                         **W.one_rank(W.STAGE))
        jax_loss = jax_mesh_loss(jm, batch, key)
        jax_model_stage = jax_mesh_step(
            W.PAR_STAGE, flat_stage, batch, key,
            make_mesh(data=1, model=2, stage=2, devices=jax.devices()[:4]),
            stage_axis="stage", n_micro=2)
    finally:
        W.join(procs, tmp, timeout=240.0)
    return {"one": one, "floor": floor, "jax": jax_loss, "one_seq_stage": one_seq_stage,
            "floor_seq_stage": floor_seq_stage, "one_model_stage": one_model_stage,
            "floor_model_stage": floor_model_stage, "jax_model_stage": jax_model_stage,
            **{case: dict(np.load(tmp / f"{case}.npz")) for case in CASES}}


def test_three_steps_at_data_2_model_2_equal_one_rank(runs):
    assert runs["data_model"]["m::loss"].shape == (3,)
    _metrics_close(runs["data_model"], runs["one"], 1e-4)


def test_first_step_gradients_at_data_2_model_2_equal_one_rank(runs):
    _grads_close(runs["data_model"], runs["one"], 1e-5, runs["floor"])


def test_data_2_model_2_step_equals_jax_mesh_step(runs):
    got, ref = runs["jax_step"], runs["jax"]
    assert set(ref) <= {k[3:] for k in got}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[f"m::{k}"]), v, rtol=1e-4, err_msg=k)


def test_three_steps_at_seq_2_stage_2_equal_one_rank(runs):
    assert runs["seq_stage"]["m::loss"].shape == (3,)
    _metrics_close(runs["seq_stage"], runs["one_seq_stage"], 1e-4)


def test_first_step_gradients_at_seq_2_stage_2_equal_one_rank(runs):
    """Within 1e-5 of each tensor's max-abs, or twice its float32 floor:
    the ring sums its chunks in another order than the ring of one, and
    the aligner's key convolution amplifies that rounding (~5e-5)."""
    _grads_close(runs["seq_stage"], runs["one_seq_stage"], 1e-5, runs["floor_seq_stage"])


def test_three_steps_at_model_2_stage_2_equal_one_rank(runs):
    assert runs["model_stage"]["m::loss"].shape == (3,)
    _metrics_close(runs["model_stage"], runs["one_model_stage"], 1e-4)


def test_first_step_gradients_at_model_2_stage_2_equal_one_rank(runs):
    """Every gradient gathered over the model and the stage groups within
    1e-5 of its max-abs, or twice its float32 floor."""
    _grads_close(runs["model_stage"], runs["one_model_stage"], 1e-5,
                 runs["floor_model_stage"])


def test_model_2_stage_2_step_equals_the_jax_mesh_step(runs):
    got, ref = runs["model_stage_jax"], runs["jax_model_stage"]
    assert {"loss", "stats/grad_norm"} <= set(ref) and set(ref) <= {k[3:] for k in got}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[f"m::{k}"]), v, rtol=1e-4, err_msg=k)
