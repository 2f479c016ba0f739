"""One training step of a small acoustic model, the port against the JAX
package, on the CPU: forward, every loss term and every parameter gradient.
float32 on both sides, dropout off, the flow predictor's noise and time
drawn as JAX draws them and handed to the port."""

import jax
import numpy as np
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from torch_port_common import SMALL, assert_grads_match, flow_draws, jax_step, perturb, port_step


def test_small_training_step_matches():
    """One training step of a small model: every loss term within 1e-4
    relative, every parameter gradient within 1e-3 of its max-abs
    (float32 through 2 + 2 + 2 + 1 layers and the aligner)."""
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, SMALL), rngs=nnx.Rngs(0))
    perturb(jm, 12)
    pm = AcousticModel(build_config(AcousticModelConfig, SMALL))
    pm.load_jax_state(jm.state_dict())
    rng = np.random.RandomState(13)
    B, T, M = 3, 12, 48
    text_len = np.array([12, 9, 6], np.int32)
    text = rng.randint(2, 11, size=(B, T)).astype(np.int32)
    text[np.arange(T)[None] >= text_len[:, None]] = 0
    inputs = {"text": text, "text_len": text_len,
              "mel": rng.randn(B, M, 16).astype(np.float32),
              "mel_len": np.array([48, 40, 30], np.int32),
              "pitch": rng.randn(B, M).astype(np.float32),
              "energy": rng.randn(B, M).astype(np.float32),
              "speaker": np.array([0, 1, 1], np.int32)}
    key = jax.random.PRNGKey(21)
    jl, jlosses, jgrads = jax_step(jm, inputs, key)
    x0, tt = flow_draws(key, B, T)
    pl, plosses = port_step(pm, inputs, x0, tt)
    assert set(plosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(plosses[k], jlosses[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert_grads_match(jgrads, pm, 1e-3)
