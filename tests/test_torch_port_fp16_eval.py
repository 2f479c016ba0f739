"""The fp16 policy and the acoustic evaluator against the JAX package, on
the CPU: one training step's loss terms in fp16 (bounded by what fp16
moves JAX's own step), and the evaluator's MCD-13 and alignment length and
strength within 1e-5 of JAX's.
"""

import jax
import numpy as np
from flax import nnx

from torch_port_common import flow_draws, t


def test_fp16_step_matches_the_jax_fp16_policy():
    """One training step's loss terms of the small model in fp16, on the
    same weights and flow draws as the JAX fp16 step. Two fp16 computations
    of one function round at different points (autocast's op lists against
    flax's dtype promotion), so the bound is set by fp16 itself: within 4x
    of what fp16 moves JAX's own step (its fp16 step against its fp32 step);
    measured on the CPU at 0.1-2.9x. The port's fp16 step must also differ
    from its fp32 one (fp16 is on)."""
    from isp_tts_tpu.config import build_config as jax_build_config
    from isp_tts_tpu.models import AcousticModel as JModel
    from isp_tts_tpu.nn.policy import compute_dtype
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic import loss as ploss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig
    from torch_port_common import SMALL, carry, jax_step as jstep, perturb

    rng = np.random.RandomState(22)
    B, T, M = 2, 10, 40
    inputs = {"text": rng.randint(2, 11, size=(B, T)).astype(np.int32),
              "text_len": np.array([10, 7], np.int32),
              "mel": rng.randn(B, M, 16).astype(np.float32),
              "mel_len": np.array([40, 31], np.int32),
              "pitch": rng.randn(B, M).astype(np.float32),
              "energy": rng.randn(B, M).astype(np.float32),
              "speaker": np.array([0, 1], np.int32)}
    key = jax.random.PRNGKey(23)
    runs = {}
    for prec in ("fp32", "fp16"):
        with compute_dtype(prec):
            jm = JModel(jax_build_config(JModel.Config, dict(SMALL)), rngs=nnx.Rngs(0))
        flat = perturb(jm, 24)
        jm.eval()
        runs[prec] = jstep(jm, inputs, key)[1]
    pm = AcousticModel(build_config(AcousticModelConfig, SMALL))
    carry(flat, pm)
    trainer = Trainer(pm.eval(), ploss.AcousticModelLoss(),
                      build_config(TrainerConfig, {"precision": "fp16"}), device="cpu")
    x0, tt = flow_draws(key, B, T)
    batch = {"text_vector": t(inputs["text"]), "text_vector_len": t(inputs["text_len"]),
             "mel": t(inputs["mel"]), "mel_len": t(inputs["mel_len"]),
             "pitch": t(inputs["pitch"]), "energy": t(inputs["energy"]),
             "speaker": t(inputs["speaker"])}
    trainer.model.eval()
    _, losses, _, _ = trainer._forward(batch, noise=t(x0), t=t(tt), step=0)
    trainer._autocast = None
    _, losses32, _, _ = trainer._forward(batch, noise=t(x0), t=t(tt), step=0)
    moved = 0.0
    for k, ref in runs["fp16"].items():
        control = abs(runs["fp16"][k] - runs["fp32"][k])
        assert control > 0, k
        assert abs(losses[k].item() - ref) <= 4 * control + 1e-6 * abs(ref), (
            k, losses[k].item(), ref, control)
        np.testing.assert_allclose(losses32[k].item(), runs["fp32"][k], rtol=1e-5)
        moved = max(moved, abs(losses[k].item() - losses32[k].item()))
    assert moved > 1e-4


def test_evaluator_metrics_match_jax():
    from isp_tts_tpu.models.acoustic.evaluator import alignment_metrics as jalign
    from isp_tts_tpu.models.acoustic.evaluator import mcd as jmcd
    from isp_tts_tpu_torch.models.acoustic.evaluator import alignment_metrics, mcd

    rng = np.random.RandomState(25)
    B, M, T = 3, 50, 12
    out = rng.randn(B, M, 80).astype(np.float32)
    tgt = rng.randn(B, M, 80).astype(np.float32)
    ml = np.array([50, 33, 20], np.int32)
    tl = np.array([12, 9, 5], np.int32)
    attn = rng.rand(B, M, T).astype(np.float32)
    attn[:, :, 0] += 0.5 * (rng.rand(B, M) > 0.7)  # ties broken the same way
    np.testing.assert_allclose(mcd(t(out), t(tgt), t(ml)).item(),
                               float(jmcd(out, tgt, ml)), rtol=1e-5)
    got = alignment_metrics(t(attn), t(ml), t(tl))
    ref = jalign(attn, ml, tl)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5)
