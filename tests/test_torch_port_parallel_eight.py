"""Eight gloo ranks on the CPU: the composed data 2 × seq 2 × stage 2 step,
against one rank and against the JAX trainer's step on the same mesh
(``__graft_entry__.py:_run_composed_train_phase``: dp2 × sp2 × pp2 on 8
devices).

The ranks (``torch_port_parallel_workers.py``) start once for the module
through a ``file://`` store. The model is ``PAR_STAGE`` with ``flash:
ring`` in the encoder (its sequence split over the seq pair), the decoder
stacked (2 layers over 2 stages, 2 microbatches), the global batch of 8
rows split over 2 data ranks, as the JAX phase composes them (8 rows: the
JAX aligner then splits its batch over all 8 devices, its manual path,
whose gradients are exact; on fewer rows it falls back to the
auto-partitioned path its docstring says miscomputes the convolutions'
gradients on such a mesh):

- 3 steps with live dropout 0.1 (the port's own scheme: the ring hashes
  global rows, the stacked stack keys its dropout by step, layer and
  global row) against one rank ringing alone with the stacked decoder
  run locally: the loss terms and gradient norm of each step within rel
  1e-4, the first step's gradients (gathered over the stage group,
  averaged over the data group) within 1e-5 of each tensor's max-abs or
  twice its float32 floor, the most over ``STAGE_FLOOR_SEEDS``' six draws
  (the ring sums its chunks in another order, the data mean halves);
- one step without dropout, with the flow draws the JAX model makes from
  its key, against the JAX step on ``make_mesh(data=2, seq=2, stage=2)``
  of the conftest's 8 virtual devices: loss terms and gradient norm within
  rel 1e-4.
"""

import jax
import numpy as np
import pytest
from flax import nnx

import torch_port_parallel_workers as W
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.parallel.mesh import make_mesh
from test_torch_port_parallel_two import _grads_close, _metrics_close, jax_mesh_step
from torch_port_common import flow_draws, perturb

CASES = ["composed", "composed_jax"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks8")
    batch = W.global_batch(B=8)
    key = jax.random.PRNGKey(21)
    x0, t = flow_draws(key, *batch["text_vector"].shape)
    jstage = JAcousticModel(jax_build_config(JAcousticModelConfig, W.PAR_STAGE_LAYERS),
                            rngs=nnx.Rngs(1))
    flat_stage = perturb(jstage, 13)
    W.save_inputs(tmp / "inputs.npz", {}, batch, ws=flat_stage, x0=x0, t=t)
    procs = W.spawn(8, tmp / "inputs.npz", tmp, CASES, tmp)
    try:
        inputs = dict(np.load(tmp / "inputs.npz"))
        layout = W.one_rank(W.COMPOSED)
        one = W.one_thread(W.case_steps, inputs, tmp / "one", model_axis=1, **layout)
        floor = W.one_thread(W.gradient_floor, inputs, tmp / "floor", one,
                             seeds=W.STAGE_FLOOR_SEEDS, **layout)
        jax_composed = jax_mesh_step(
            W.COMPOSED["model"], flat_stage, batch, key,
            make_mesh(data=2, seq=2, stage=2, devices=jax.devices()[:8]),
            seq_axis="seq", stage_axis="stage", n_micro=2)
    finally:
        W.join(procs, tmp, timeout=240.0)
    return {"one": one, "floor": floor, "jax": jax_composed,
            **{case: dict(np.load(tmp / f"{case}.npz")) for case in CASES}}


def test_three_composed_steps_equal_one_rank(runs):
    assert runs["composed"]["m::loss"].shape == (3,)
    _metrics_close(runs["composed"], runs["one"], 1e-4)


def test_first_composed_step_gradients_equal_one_rank(runs):
    _grads_close(runs["composed"], runs["one"], 1e-5, runs["floor"])


def test_composed_step_equals_the_jax_mesh_step(runs):
    got, ref = runs["composed_jax"], runs["jax"]
    assert {"loss", "stats/grad_norm"} <= set(ref) and set(ref) <= {k[3:] for k in got}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[f"m::{k}"]), v, rtol=1e-4, err_msg=k)
