"""The port's audio ops and Vocos vocoder against the JAX package's, on the CPU.

Host constants (filterbank, DFT bases, windows, overlap-add normaliser, the
filterbank's pseudo-inverse) are built by the same numpy code and must be
equal. Transforms on unit-scale inputs agree to 1e-5 of their max-abs (the
log-mels to 1e-4 absolute); Griffin-Lim, fed JAX's own start phases, to
2e-3 after 32 iterations; the generators to 1e-5 (one block) and 1e-4 of
max-abs (a small perturbed generator), and the committed vocoder at full
width to 1e-3 absolute on a mel the JAX acoustic model made. Inputs are drawn
with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.models.vocoder import VocoderModel as JVocoderModel
from isp_tts_tpu.models.vocoder.model import ConvNeXtBlock as JConvNeXtBlock
from isp_tts_tpu.models.vocoder.model import VocosGenerator as JVocosGenerator
from isp_tts_tpu.models.vocoder.model import VocosGeneratorConfig as JVocosGeneratorConfig
from isp_tts_tpu.ops import audio as jaudio
from isp_tts_tpu.ops import vocoder as jvoc
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.models.vocoder import VocoderModel
from isp_tts_tpu_torch.models.vocoder.model import ConvNeXtBlock, VocosGenerator, VocosGeneratorConfig
from isp_tts_tpu_torch.ops import audio as paudio
from isp_tts_tpu_torch.ops import vocoder as pvoc
from torch_port_common import carry, jax_flat, perturb, t

VOCODER = "docs/assets/scale_r5/vocoder_joint10k_r5.f16.ckpt"
SR = 22050


def _close(got, ref, rel):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), f"{err:.3e} vs max-abs {np.abs(ref).max():.3e}"


def _jax_angles(shape, key=0):
    """The start phases JAX's Griffin-Lim draws from ``PRNGKey(key)``."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(key), shape,
                                         minval=-np.pi, maxval=np.pi)).astype(np.float32)


@pytest.mark.parametrize("geometry", [(22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, None),
                                      (24000, 1024, 100, 0.0, 12000.0)])
def test_host_constants_are_equal(geometry):
    sr, n_fft, n_mels, f_min, f_max = geometry
    np.testing.assert_array_equal(paudio.mel_filterbank(sr, n_fft, n_mels, f_min, f_max),
                                  jaudio.mel_filterbank(sr, n_fft, n_mels, f_min, f_max))
    np.testing.assert_array_equal(pvoc._mel_pinv(sr, n_fft, n_mels, f_min, f_max),
                                  jvoc._mel_pinv(sr, n_fft, n_mels, f_min, f_max))
    for a, b in zip(pvoc._dft_bases(n_fft), jvoc._dft_bases(n_fft)):
        np.testing.assert_array_equal(a, b)
    for win in (n_fft, n_fft - 200):
        np.testing.assert_array_equal(pvoc._synth_window(win, n_fft),
                                      jvoc._synth_window(win, n_fft))
        np.testing.assert_array_equal(pvoc._ola_norm(37, n_fft, n_fft // 4, win),
                                      jvoc._ola_norm(37, n_fft, n_fft // 4, win))
    # computed on the device in f32 by both (cos rounds differently)
    np.testing.assert_allclose(paudio.hann_window(n_fft).numpy(),
                               np.asarray(jaudio.hann_window(n_fft)), atol=1e-7)


def test_frame_signal_and_stft_magnitude_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5000).astype(np.float32)
    np.testing.assert_array_equal(paudio.frame_signal(t(x), 1024, 256).numpy(),
                                  np.asarray(jaudio.frame_signal(jnp.asarray(x), 1024, 256)))
    assert paudio.frame_signal(t(x[:, :100]), 1024, 256).shape == (2, 0, 1024)
    for win in (1024, 800):
        _close(paudio.stft_magnitude(t(x), 1024, 256, win),
               jaudio.stft_magnitude(jnp.asarray(x), 1024, 256, win), 1e-5)


def test_unit_scale_transforms_match():
    rng = np.random.RandomState(1)
    B, F, T, n_fft, hop = 2, 513, 23, 1024, 256
    re, im = rng.randn(B, F, T).astype(np.float32), rng.randn(B, F, T).astype(np.float32)
    audio, n = pvoc.istft_matmul(t(re), t(im), n_fft, hop, n_fft)
    jaud, jn = jvoc.istft_matmul(jnp.asarray(re), jnp.asarray(im), n_fft, hop, n_fft)
    assert n == jn
    _close(audio, jaud, 1e-5)
    frames = rng.randn(B, T, n_fft).astype(np.float32)
    _close(pvoc._ola_dense(t(frames), hop), jvoc._ola_dense(jnp.asarray(frames), hop), 1e-5)
    x = rng.randn(B, 6000).astype(np.float32)
    for a, b in zip(pvoc._stft_matmul(t(x), n_fft, hop, n_fft, 384),
                    jvoc._stft_matmul(jnp.asarray(x), n_fft, hop, n_fft, 384)):
        _close(a, b, 1e-5)
    spec = re + 1j * im
    for win in (1024, 900):
        _close(pvoc.istft(t(spec), n_fft, hop, win), jvoc.istft(jnp.asarray(spec), n_fft, hop, win),
               1e-5)
    log_mel = rng.randn(B, T, 80).astype(np.float32)
    _close(pvoc.mel_to_linear(t(log_mel), SR), jvoc.mel_to_linear(jnp.asarray(log_mel), SR), 1e-5)


def test_log_mels_match():
    rng = np.random.RandomState(2)
    x = (0.3 * rng.randn(2, 8000)).astype(np.float32)
    np.testing.assert_allclose(pvoc.log_mel_matmul(t(x)).numpy(),
                               np.asarray(jvoc.log_mel_matmul(jnp.asarray(x))), atol=1e-4)
    np.testing.assert_allclose(paudio.log_mel_spectrogram(t(x), SR).numpy(),
                               np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(x), SR)), atol=1e-4)


def _sine_mel(frames=40):
    n = 256 * frames
    tt = np.arange(n) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1330 * tt)
             + 0.01 * np.random.RandomState(3).randn(n)).astype(np.float32)
    return np.asarray(jvoc.log_mel_matmul(jnp.asarray(audio)))  # (frames, 80)


@pytest.mark.parametrize("variant", ["griffin_lim", "griffin_lim_matmul", "mel_to_audio",
                                     "mel_to_audio_tpu"])
def test_griffin_lim_with_jax_start_phases_matches(variant):
    log_mel = np.stack([_sine_mel(), _sine_mel()[::-1]])  # (2, 40, 80)
    mag = np.asarray(jvoc.mel_to_linear(jnp.asarray(log_mel), SR)) ** 1.2
    angles = _jax_angles(mag.shape)
    if variant.startswith("griffin"):
        ref = getattr(jvoc, variant)(jnp.asarray(mag), n_iter=32)
        got = getattr(pvoc, variant)(t(mag), n_iter=32, angles=t(angles))
    else:
        ref = getattr(jvoc, variant)(jnp.asarray(log_mel), SR, n_iter=32)
        got = getattr(pvoc, variant)(t(log_mel), SR, n_iter=32, angles=t(angles))
    assert got.shape == (2, 40 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)


def test_griffin_lim_default_phases_are_seeded():
    mag = torch.rand(1, 513, 12)
    a = pvoc.griffin_lim_matmul(mag, n_iter=2)
    b = pvoc.griffin_lim_matmul(mag, n_iter=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("approximate", [True, False])
def test_convnext_block_matches(approximate):
    jb = JConvNeXtBlock(64, 96, 0.5, gelu_approximate=approximate, rngs=nnx.Rngs(0))
    flat = perturb(jb, 4)
    pb = ConvNeXtBlock(64, 96, 0.5, gelu_approximate=approximate)
    carry(flat, pb)
    x = np.random.RandomState(5).randn(2, 19, 64).astype(np.float32)
    np.testing.assert_allclose(pb(t(x)).detach().numpy(), np.asarray(jb(jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("min_log_mag", [-4.6, None])
def test_small_generator_matches(gelu, min_log_mag):
    cfg = dict(n_mels=16, dim=48, intermediate_dim=96, num_layers=3, n_fft=256, hop_length=64,
               gelu=gelu, min_log_mag=min_log_mag)
    jg = JVocosGenerator(JVocosGeneratorConfig(**cfg), rngs=nnx.Rngs(1))
    flat = perturb(jg, 6, scale=0.3)
    pg = VocosGenerator(VocosGeneratorConfig(**cfg))
    carry(flat, pg)
    mel = np.random.RandomState(7).randn(2, 21, 16).astype(np.float32)
    ref = np.asarray(jg(jnp.asarray(mel)))
    assert ref.shape == (2, 21 * 64)
    # the clips bind on some bins: exp(log_mag) saturates at max_log_mag
    _close(pg(t(mel)).detach(), ref, 1e-4)


@pytest.fixture(scope="module")
def committed():
    jm = JVocoderModel.from_pretrained(VOCODER)
    jm.eval()
    pm = VocoderModel.from_pretrained(VOCODER, device="cpu")
    return jm, pm


def test_committed_vocoder_loads_every_tensor(committed):
    _, pm = committed
    state = load_checkpoint(VOCODER)["model"]["state"]
    # the checkpoint holds the generator alone; the model also carries the
    # GAN discriminators, left at their initial values
    assert len(state) == 80 and len(pm.generator.state_dict()) == 80
    assert sum(p.numel() for p in pm.generator.parameters()) == 13_459_970
    assert not any(k.startswith("discriminator.") for k in state)
    assert len(pm.discriminator.period_discs) == len(pm.config.discriminator.periods) == 5
    w = pm.generator.blocks[0].dwconv.weight
    assert w.shape == (512, 1, 7) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.detach().numpy()[:, 0, :],
                                  state["generator.blocks.0.dwconv.kernel"][:, 0, :].T)
    assert pm.features_config.sample_rate == 22050


def test_committed_vocoder_full_width_matches(committed, jax_mel):
    jm, pm = committed
    ref = np.asarray(jm.infer(jnp.asarray(jax_mel)))
    got = pm.infer(t(jax_mel))
    assert got.shape == ref.shape == (1, jax_mel.shape[1] * 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    # the generator's training forward: features of real audio, then the mel
    audio = np.clip(ref, -1, 1)[:, : 256 * 64]
    out = pm(t(audio))
    jout = jm(jnp.asarray(audio))
    # log-mels of quiet frames reach -11.5 (log 1e-5): held relative there
    np.testing.assert_allclose(out.mel.numpy(), np.asarray(jout.mel), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.audio_fake.detach().numpy(), np.asarray(jout.audio_fake),
                               atol=1e-3)


@pytest.fixture(scope="module")
def jax_mel():
    """A mel of the committed acoustic model (JAX, seed 0), 150 frames."""
    from isp_tts_tpu.models import AcousticModel as JAcousticModel
    from isp_tts_tpu.data.providers import TextProvider as JTextProvider
    from isp_tts_tpu.data.providers import TextProviderConfig

    jm = JAcousticModel.from_pretrained("docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt")
    jm.eval()
    enc = JTextProvider(TextProviderConfig(charset=["<pad>", "</s>", "#punct", "#en"]))(
        "The birch canoe slid away.")
    mel, ad = jm.infer(jnp.asarray(enc.vector)[None], max_dec_len=256,
                       key=jax.random.PRNGKey(0))
    n = int(ad.dec_lengths[0])
    assert 100 < n < 256
    return np.asarray(mel)[:, :n]


def test_checkpoint_suffixes_of_torch_vocos_raise(tmp_path):
    """The torch Vocos suffixes, refused until the reference interop was
    ported, now each load: the committed vocoder's generator written as a
    ``.pt``, ``.pth`` and ``.bin`` state dict and as a TorchScript ``.pts``
    comes back bit for bit (``tests/test_torch_port_vocos_interop.py`` holds
    the files to the JAX package's)."""
    from isp_tts_tpu_torch.models.vocoder.interop import export_vocos_state, save_torch_vocoder
    from torch_port_common import save_torchscript_state

    src = VocoderModel.from_pretrained(VOCODER, device="cpu")
    for suffix in (".pt", ".pth", ".bin"):
        save_torch_vocoder(src, tmp_path / f"vocos{suffix}")
    save_torchscript_state({k: torch.from_numpy(v) for k, v in
                            export_vocos_state(src.state_dict()).items()},
                           tmp_path / "vocos.pts")
    want = src.generator.state_dict()
    for suffix in (".pt", ".pts", ".pth", ".bin"):
        got = VocoderModel.from_pretrained(tmp_path / f"vocos{suffix}", device="cpu")
        assert got.generator.state_dict().keys() == want.keys()
        for k, v in got.generator.state_dict().items():
            assert torch.equal(v, want[k]), (suffix, k)


def test_jax_flat_names_cover_the_port_generator():
    jg = JVocosGenerator(JVocosGeneratorConfig(n_mels=8, dim=16, intermediate_dim=32,
                                               num_layers=2, n_fft=64, hop_length=16),
                         rngs=nnx.Rngs(0))
    pg = VocosGenerator(VocosGeneratorConfig(n_mels=8, dim=16, intermediate_dim=32,
                                             num_layers=2, n_fft=64, hop_length=16))
    carry(jax_flat(jg), pg)  # strict: every name maps and every shape fits
