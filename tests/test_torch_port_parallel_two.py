"""Two gloo ranks on the CPU against one rank, and against the JAX package.

The ranks (``torch_port_parallel_workers.py``) start once for the module
through a ``file://`` store and run every case: the small acoustic model
of ``PAR`` (float32, live attention and feed-forward dropout 0.1, the
decoder's feed-forward a GLU, the predictor with H key/value heads) for 3
steps at data 2 and at model 2, and one GAN step of the tiny vocoder at
data 2. The one-rank references run here, while the ranks work:

- data 2 and model 2 against one rank: the first step's gradients within
  1e-5 of each tensor's max-abs, the loss terms and the gradient norm of
  each of the 3 steps within rel 1e-4. Under a model split the sums over
  the model group round the activations differently (~1 ulp), and a few
  gradients move by more than 1e-5 of their max-abs under such rounding
  in one rank alone (the aligner's key convolution by ~5e-5: its input,
  the encoder's output, enters a normalised short convolution); for those
  the bound is twice that measured floor (``gradient_floor``);
- the GAN step at data 2 against the port's one rank (metrics rel 1e-5,
  every parameter after the update within 1e-5) and against the JAX
  GANTrainer's jitted step on the same batch and weights (metrics rel
  1e-5, the bound of ``test_torch_port_gan_train.py``);
- seq 2 (``flash: ring`` in the encoder and the decoder) and stage 2 (the
  decoder stacked, 2 layers, 2 microbatches) against one rank (ringing
  alone on a size-1 seq axis; the stacked decoder locally), with live
  dropout: each step's loss terms and gradient norm within rel 1e-4, the
  first step's gradients within 1e-5 of each tensor's max-abs or twice
  its float32 floor measured on the case's model; and without dropout, with JAX's flow draws, against
  the JAX model's step on ``make_mesh(data=1, seq=2)`` (ring attention
  over the mesh) and ``make_mesh(data=1, stage=2)`` (the GPipe schedule
  over it): loss terms and gradient norm within rel 1e-4;
- data 2's logged readings against the JAX step on ``make_mesh(data=2)``:
  a micro-step's ``stats/grad_norm`` under an accumulation of 2 (the norm
  of the global micro-batch's gradient) within rel 1e-4, and the
  evaluator's ``metrics/alignment_strength`` (one ratio over the global
  batch) within rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import torch_port_parallel_workers as W
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic import loss as jloss
from isp_tts_tpu.models.acoustic.evaluator import AcousticModelEvaluator as JEvaluator
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.parallel.context import parallel_context as jax_parallel_context
from isp_tts_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from isp_tts_tpu.training.experiment import ExperimentModules as JExperimentModules
from torch_port_common import flow_draws, jax_flat, perturb, write_toy_dataset

CASES = ["data", "model", "accumulate", "gan", "seq", "stage", "seq_jax", "stage_jax",
         "data_metrics"]
GAN_METRICS = ("loss", "losses/disc", "losses/gen_adv", "losses/feature_matching",
               "losses/mel", "stats/grad_norm", "stats/grad_norm_disc")


def acoustic_weights() -> dict:
    """JAX-initialised PAR weights, perturbed so every module carries signal."""
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, W.PAR), rngs=nnx.Rngs(0))
    return perturb(jm, 12)


def jax_model(cfg: dict, flat: dict):
    """The JAX acoustic model of ``cfg`` without dropout, on ``flat``
    (per-layer names: a stacked decoder takes them through its
    translation)."""
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, W.without_dropout(cfg)),
                        rngs=nnx.Rngs(0))
    jm.load_params(flat)
    return jm


def jax_inputs(batch: dict, mesh) -> dict:
    return shard_batch({"text": batch["text_vector"], "text_len": batch["text_vector_len"],
                        "mel": batch["mel"], "mel_len": batch["mel_len"],
                        "pitch": batch["pitch"], "energy": batch["energy"],
                        "speaker": batch["speaker"]}, mesh)


def jax_mesh_step(cfg: dict, flat: dict, batch: dict, key, mesh, **ctx) -> dict:
    """The JAX model's loss terms and gradient norm over ``mesh`` (the
    parallel context ``ctx`` live while it traces)."""
    jm = jax_model(cfg, flat)
    nnx.update(jm, shard_params(nnx.state(jm), mesh))
    crit = jloss.AcousticModelLoss()

    @nnx.jit
    def step(m, x):
        def loss_fn(m):
            return crit(x, m(**x, key=key), 0)

        (loss, losses), grads = nnx.value_and_grad(loss_fn, has_aux=True)(m)
        return loss, losses, optax.global_norm(grads)

    with jax_parallel_context(mesh=mesh, **ctx):
        loss, losses, norm = step(jm, jax_inputs(batch, mesh))
    return {"loss": float(loss), "stats/grad_norm": float(norm),
            **{k: float(v) for k, v in losses.items()}}


def jax_alignment_strength(flat: dict, batch: dict, key, mesh) -> float:
    """The JAX evaluator's attention strength over the global batch, the
    model in eval mode on ``mesh``."""
    jm = jax_model(W.PAR, flat)
    jm.eval()
    x = jax_inputs(batch, mesh)
    outputs = nnx.jit(lambda m, x: m(**x, key=key))(jm, x)
    return float(JEvaluator()(x, outputs)["metrics/alignment_strength"])


def jax_gan_trainer(root, outdir):
    overrides = W.gan_overrides(root, outdir)
    overrides["trainer"]["num_devices"] = 1
    modules = JExperimentModules("vocoder/vocos", "recipes", overrides=overrides)
    modules.init_modules()
    return modules.build_trainer()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks2")
    root = tmp / "toy"
    write_toy_dataset(root)
    with torch.random.fork_rng():
        one_gan = W.gan_trainer(root, tmp / "one_gan")
        gan_batch = {k: v for k, v in next(iter(one_gan.train_loader)).items()
                     if isinstance(v, np.ndarray)}
    jt = jax_gan_trainer(root, tmp / "jax_gan")
    batch = W.global_batch()
    key = jax.random.PRNGKey(21)
    x0, t = flow_draws(key, *batch["text_vector"].shape)
    flat = acoustic_weights()
    jstage = JAcousticModel(jax_build_config(JAcousticModelConfig, W.PAR_STAGE_LAYERS),
                            rngs=nnx.Rngs(1))
    flat_stage = perturb(jstage, 13)
    W.save_inputs(tmp / "inputs.npz", flat, batch, ws=flat_stage, x0=x0, t=t,
                  gw=jax_flat(jt.model), gb=gan_batch, gan_root=str(root))
    procs = W.spawn(2, tmp / "inputs.npz", tmp, CASES, tmp)
    try:
        inputs = dict(np.load(tmp / "inputs.npz"))
        one = W.one_thread(W.case_steps, inputs, tmp / "one", model_axis=1)
        one_accumulate = W.one_thread(W.case_accumulate, inputs, tmp / "one_acc", model_axis=1)
        floor = W.one_thread(W.gradient_floor, inputs, tmp / "floor", one)
        one_seq = W.one_thread(W.case_steps, inputs, tmp / "one_seq", model_axis=1,
                               **W.one_rank(W.SEQ))
        one_stage = W.one_thread(W.case_steps, inputs, tmp / "one_stage", model_axis=1,
                                 **W.one_rank(W.STAGE))
        floors = {case: W.one_thread(W.gradient_floor, inputs, tmp / f"floor_{case}", ref,
                                     **W.one_rank(layout))
                  for case, ref, layout in (("seq", one_seq, W.SEQ),
                                            ("stage", one_stage, W.STAGE))}
        one_gan = W.one_thread(W.case_gan, inputs, tmp / "one_gan2")
        jt.opt_state = jt._apply_lr(jt.schedule(0, 0))
        jt._build_steps()
        fn = jt._step_for_mode("train")
        _, ref = fn(jt.opt_state, {k: jnp.asarray(v) for k, v in gan_batch.items()},
                    jnp.asarray(0, jnp.int32))
        jax_gan = {k: float(v) for k, v in ref.items()}
        devices = jax.devices()
        jax_seq = jax_mesh_step(W.with_ring(W.PAR), flat, batch, key,
                                make_mesh(data=1, seq=2, devices=devices[:2]), seq_axis="seq")
        jax_stage = jax_mesh_step(W.PAR_STAGE, flat_stage, batch, key,
                                  make_mesh(data=1, stage=2, devices=devices[:2]),
                                  stage_axis="stage", n_micro=2)
        data2 = make_mesh(data=2, devices=devices[:2])
        jax_data = jax_mesh_step(W.PAR, flat, batch, key, data2)
        jax_strength = jax_alignment_strength(flat, batch, key, data2)
    finally:
        W.join(procs, tmp, timeout=240.0)
    return {"one": one, "floor": floor, "one_gan": one_gan, "jax_gan": jax_gan,
            "one_accumulate": one_accumulate, "one_seq": one_seq, "one_stage": one_stage,
            "jax_seq": jax_seq, "jax_stage": jax_stage, "jax_data": jax_data,
            "jax_strength": jax_strength, **{f"floor_{k}": v for k, v in floors.items()},
            **{case: dict(np.load(tmp / f"{case}.npz")) for case in CASES}}


def _metrics_close(got, ref, rtol):
    keys = [k for k in ref if k.startswith("m::")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=0, err_msg=k)


def _grads_close(got, ref, bound, floor=None):
    """Every gradient within ``bound`` of its max-abs, or within twice its
    measured float32 floor where that is larger."""
    keys = [k for k in ref if k.startswith("g::")]
    assert keys and set(keys) == {k for k in got if k.startswith("g::")}
    for k in keys:
        scale = max(np.abs(ref[k]).max(), 1e-12)
        err = np.abs(got[k] - ref[k]).max()
        allowed = max(bound, 2 * floor[k]) if floor else bound
        assert err <= allowed * scale, f"{k}: {err:.3e} > {allowed:.2e} * {scale:.3e}"


@pytest.mark.parametrize("case", ["data", "model"])
def test_three_steps_equal_one_rank(runs, case):
    """Loss terms and gradient norm of each step within rel 1e-4."""
    assert runs[case]["m::loss"].shape == (3,)
    _metrics_close(runs[case], runs["one"], 1e-4)


def test_first_step_gradients_at_data_2_equal_one_rank(runs):
    """Every parameter's gradient within 1e-5 of its max-abs: each row's
    forward is one rank's, only the gradient mean sums in another order."""
    _grads_close(runs["data"], runs["one"], 1e-5)


def test_first_step_gradients_at_model_2_equal_one_rank(runs):
    """Every parameter's gradient (split ones gathered) within 1e-5 of its
    max-abs, or twice its float32 floor."""
    _grads_close(runs["model"], runs["one"], 1e-5, runs["floor"])


def test_accumulation_with_a_freeze_mask_at_model_2_equals_one_rank(runs):
    """Two micro-steps accumulated (reduced once, when applied) with the
    aligner, encoder and embedding frozen: each micro-step's loss terms
    within rel 1e-4 (the third after the update); the parameters after it
    within 1e-5 but for at most 1e-3 of them within 2 x lr, where AdamW's
    first step turns a near-zero gradient's rounding into a sign; each
    micro-step's logged gradient norm within rel 1e-4 (the global
    micro-batch's, as one rank logs it)."""
    got, ref = runs["accumulate"], runs["one_accumulate"]
    for k in ("m::loss", "m::model/mel_loss", "m::adaptor/flow_loss", "m::stats/grad_norm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=0, err_msg=k)
    params = [k for k in ref if k.startswith("p::")]
    moved = frozen = 0
    total = 0
    for k in params:
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2e-3 + 1e-5, k
        moved += int((diff > 1e-5).sum())
        total += diff.size
        if not k.startswith(("p::decoder.", "p::temporal_adaptor.predictor.")):
            frozen += int((got[k] != ref[k]).sum())
    assert moved <= 1e-3 * total and frozen == 0, (moved, total, frozen)


def test_gan_step_at_data_2_equals_one_rank(runs):
    got, ref = runs["gan"], runs["one_gan"]
    _metrics_close(got, ref, 1e-5)
    params = [k for k in ref if k.startswith("p::")]
    assert params
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)


def test_gan_step_at_data_2_equals_jax(runs):
    got, ref = runs["gan"], runs["jax_gan"]
    for k in GAN_METRICS:
        a, b = float(got[f"m::{k}"]), ref[k]
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-6), (k, a, b)


@pytest.mark.parametrize("case", ["seq", "stage"])
def test_three_steps_at_seq_2_and_stage_2_equal_one_rank(runs, case):
    """Live dropout: the ring's keep mask hashes global rows, the stacked
    stack's dropout is keyed by step, layer and global row."""
    assert runs[case]["m::loss"].shape == (3,)
    _metrics_close(runs[case], runs[f"one_{case}"], 1e-4)


@pytest.mark.parametrize("case", ["seq", "stage"])
def test_first_step_gradients_at_seq_2_and_stage_2_equal_one_rank(runs, case):
    """Within 1e-5 of each tensor's max-abs, or twice its float32 floor
    measured on the case's model (the ring sums its chunks in another
    order)."""
    _grads_close(runs[case], runs[f"one_{case}"], 1e-5, runs[f"floor_{case}"])


@pytest.mark.parametrize("case", ["seq", "stage"])
def test_seq_2_and_stage_2_steps_equal_the_jax_mesh_step(runs, case):
    got, ref = runs[f"{case}_jax"], runs[f"jax_{case}"]
    assert {"loss", "stats/grad_norm"} <= set(ref) and set(ref) <= {k[3:] for k in got}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[f"m::{k}"]), v, rtol=1e-4, err_msg=k)


def test_data_2_micro_step_grad_norm_is_the_jax_global_norm(runs):
    got, ref = runs["data_metrics"], runs["jax_data"]
    for k in ("loss", "stats/grad_norm"):
        np.testing.assert_allclose(float(got[f"m::{k}"]), ref[k], rtol=1e-4, err_msg=k)


def test_data_2_alignment_strength_is_the_jax_global_ratio(runs):
    got = float(runs["data_metrics"]["e::metrics/alignment_strength"])
    np.testing.assert_allclose(got, runs["jax_strength"], rtol=1e-5)
