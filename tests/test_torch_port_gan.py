"""The vocoder's GAN path against the JAX package, on the CPU, float32.

Tiny widths (the JAX vocoder tests' TINY_MODEL), JAX's initial parameters
carried into the port through ``VocoderModel.load_jax_state``, inputs drawn
with numpy from a seed:

- each sub-discriminator's logits and features (NHWC permuted to NCHW)
  within 1e-5 of JAX's max-abs; ``WNConv`` invariant to the magnitude of v;
- ``disc_loss``, ``gen_loss`` and the evaluation loss, LSGAN and hinge,
  within 1e-5 relative; the gradients of both branches within 1e-4 of each
  gradient's max-abs against ``nnx.value_and_grad``;
- ``multires_stft_distance`` within 1e-5 relative;
- one whole GAN step (AdamW, clip 1.0) of the port's GANTrainer against the
  JAX GANTrainer's jitted ``train_step`` on the same batch: the metrics
  within 1e-5 relative and every updated parameter within 1e-5 absolute.
  The port runs the generator forward once for both halves, JAX twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config.registry import build_config as jbuild_config
from isp_tts_tpu.models.vocoder import VocoderModel as JVocoderModel
from isp_tts_tpu.models.vocoder import VocoderModelConfig as JVocoderModelConfig
from isp_tts_tpu.models.vocoder.evaluator import multires_stft_distance as jmultires
from isp_tts_tpu.models.vocoder.loss import VocoderGANLoss as JLoss
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.vocoder import VocoderGANLoss, VocoderModel, VocoderModelConfig
from isp_tts_tpu_torch.models.vocoder.discriminator import WNConv
from isp_tts_tpu_torch.models.vocoder.evaluator import multires_stft_distance
from isp_tts_tpu_torch.training.optimizers import jax_param_name, to_jax_array
from torch_port_common import jax_flat

SR = 22050
TINY_FEATURES = {"sample_rate": SR, "n_fft": 256, "hop_length": 64, "win_length": 256,
                 "n_mels": 16, "f_min": 0.0, "f_max": 8000.0}
TINY_MODEL = {
    "features": TINY_FEATURES,
    "generator": {"dim": 32, "intermediate_dim": 64, "num_layers": 2},
    "discriminator": {"periods": [2, 3], "resolutions": [[256, 64], [512, 128]],
                      "mpd_channels": [4, 8], "mrd_channels": 4},
}
SAMPLES = 1024 + 64  # odd periods pad by reflection; 17 mel frames


def models(seed=0):
    jm = JVocoderModel(jbuild_config(JVocoderModelConfig, dict(TINY_MODEL)),
                       rngs=nnx.Rngs(seed))
    pm = VocoderModel(build_config(VocoderModelConfig, dict(TINY_MODEL)))
    pm.load_jax_state(jax_flat(jm))
    return jm, pm


def audio(B=3, S=SAMPLES, seed=0):
    rng = np.random.RandomState(seed)
    tt = np.arange(S) / SR
    x = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * tt) + 0.05 * rng.randn(B, S)
    return x.astype(np.float32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def pair():
    return models()


def test_discriminators_match_jax(pair):
    jm, pm = pair
    x = audio()
    jl, jf = jm.discriminator(jnp.asarray(x))
    with torch.no_grad():
        pl, pf = pm.discriminator(torch.from_numpy(x))
    assert len(pl) == len(jl) == 4
    for i, (a, b) in enumerate(zip(pl, jl)):
        assert a.shape == b.shape and rel(a, b) <= 1e-5, i
        for j, (fa, fb) in enumerate(zip(pf[i], jf[i])):
            nhwc = fa.permute(0, 2, 3, 1)
            assert nhwc.shape == fb.shape and rel(nhwc, fb) <= 1e-5, (i, j)


def test_weight_norm_conv_magnitude_invariance():
    """The output depends on v only through its direction."""
    torch.manual_seed(0)
    conv = WNConv(1, 4, (3, 3))
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 8, 8).astype(np.float32))
    with torch.no_grad():
        y1 = conv(x)
        conv.v.mul_(7.3)
        y2 = conv(x)
    torch.testing.assert_close(y1, y2, atol=1e-5, rtol=0)


def _branch_grads(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """``module``'s gradients under JAX names (relative to it), JAX layout."""
    out = {}
    for n, p in module.named_parameters():
        jname, layout = jax_param_name(module, n)
        out[jname] = to_jax_array(p.grad.numpy(), layout)
    return out


def _assert_grads(got: dict, jgrads, bound: float):
    ref = jax_flat(jgrads)
    assert set(got) == set(ref)
    for k, g in ref.items():
        scale = max(np.abs(g).max(), 1e-12)
        assert np.abs(got[k] - g).max() <= bound * scale, k


@pytest.mark.parametrize("adversarial", ["lsgan", "hinge"])
def test_losses_and_gradients_match_jax(pair, adversarial):
    jm, pm = pair
    real = audio(seed=1)
    crit_j = JLoss(adversarial=adversarial, **TINY_FEATURES)
    crit_p = VocoderGANLoss(adversarial=adversarial, **TINY_FEATURES)
    mel_j = jm.features(jnp.asarray(real))
    fake_j = jm.generator(mel_j)
    mel_p = pm.features(torch.from_numpy(real))
    assert rel(mel_p, mel_j) <= 1e-5

    # discriminator side, its gradients
    def d_fn(d):
        return crit_j.disc_loss(d, jnp.asarray(real), jax.lax.stop_gradient(fake_j))

    (jd, jdm), jdg = nnx.jit(nnx.value_and_grad(d_fn, has_aux=True))(jm.discriminator)
    pm.zero_grad()
    fake_p = pm.generator(mel_p)
    pd, pdm = crit_p.disc_loss(pm.discriminator, torch.from_numpy(real), fake_p.detach())
    pd.backward()
    assert rel(pd.detach(), jd) <= 1e-5
    assert rel(pdm["losses/disc"].detach(), jdm["losses/disc"]) <= 1e-5
    _assert_grads(_branch_grads(pm.discriminator), jdg, 1e-4)

    # generator side, its gradients (the discriminator a constant)
    disc = jm.discriminator

    def g_fn(g):
        return crit_j.gen_loss(disc, jnp.asarray(real), g(mel_j), mel_j)

    (jg, jgm), jgg = nnx.jit(nnx.value_and_grad(g_fn, has_aux=True))(jm.generator)
    pm.zero_grad()
    pg, pgm = crit_p.gen_loss(pm.discriminator, torch.from_numpy(real), pm.generator(mel_p),
                              mel_p)
    pg.backward(inputs=list(pm.generator.parameters()))
    assert rel(pg.detach(), jg) <= 1e-5
    for k in ("losses/gen_adv", "losses/feature_matching", "losses/mel"):
        assert rel(pgm[k].detach(), jgm[k]) <= 1e-5, k
    _assert_grads(_branch_grads(pm.generator), jgg, 1e-4)

    # evaluation loss (the trainer's criterion contract)
    with torch.no_grad():
        out_p = pm(torch.from_numpy(real))
        pe, pem = crit_p({"audio": torch.from_numpy(real)}, out_p)
    out_j = jm(jnp.asarray(real))
    je, jem = crit_j({"audio": jnp.asarray(real)}, out_j)
    assert rel(pe, je) <= 1e-5
    for k in ("losses/mel", "losses/wave_l1"):
        assert rel(pem[k], jem[k]) <= 1e-5, k


def test_multires_stft_distance_matches_jax():
    a, b = audio(B=2, S=4096, seed=2), audio(B=2, S=4096, seed=3)
    b[1] *= 0.1  # a quiet utterance: the per-utterance ratio, then the mean
    sc, mag = multires_stft_distance(torch.from_numpy(a), torch.from_numpy(b))
    jsc, jmag = jmultires(jnp.asarray(a), jnp.asarray(b))
    assert rel(sc, jsc) <= 1e-5 and rel(mag, jmag) <= 1e-5
