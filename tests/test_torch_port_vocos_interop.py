"""Torch Vocos interop of the port's vocoder against the JAX package's, on
the CPU: Vocos files the JAX package writes (``save_torch_vocoder``: a
``.pt``, ``.pth`` or ``.bin`` state dict) or that hold its tensors in a
TorchScript ``.pts`` load into the port bit-equal to the same model's
``.ckpt``; the port's own Vocos files load into the JAX package bit-equal;
a Vocos variant, or a pickled module, is refused; the synthesize CLI takes
a ``.pts`` vocoder."""

import wave

import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config.registry import build_config as jbuild
from isp_tts_tpu.models.vocoder import interop as jinterop
from isp_tts_tpu.models.vocoder.model import VocoderModel as JVocoder
from isp_tts_tpu.models.vocoder.model import VocoderModelConfig as JVocoderConfig
from isp_tts_tpu_torch.models.vocoder import VocoderModel
from isp_tts_tpu_torch.models.vocoder import interop as pinterop
from torch_port_common import jax_flat, perturb, save_torchscript_state

N_MELS, N_FFT, HOP = 16, 64, 16
GEN = {"n_mels": N_MELS, "dim": 16, "intermediate_dim": 32, "num_layers": 2,
       "n_fft": N_FFT, "hop_length": HOP}
FEATURES = {"sample_rate": 22050, "n_fft": N_FFT, "hop_length": HOP, "win_length": N_FFT,
            "n_mels": N_MELS, "f_min": 0.0, "f_max": 8000.0}
TINY_DISC = {"periods": [2], "resolutions": [[64, 16]], "mpd_channels": [2],
             "mrd_channels": 2}
SUFFIXES = (".pt", ".pth", ".bin", ".pts")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(JAX vocoder, its .ckpt, {suffix: Vocos file of its generator})."""
    d = tmp_path_factory.mktemp("vocos")
    jm = JVocoder(jbuild(JVocoderConfig, {"generator": GEN, "features": FEATURES,
                                          "discriminator": TINY_DISC}), rngs=nnx.Rngs(3))
    perturb(jm, 5)
    jm.save_pretrained(d / "v.ckpt")
    out = {}
    for suffix in (".pt", ".pth", ".bin"):
        jinterop.save_torch_vocoder(jm, d / f"v{suffix}")
        out[suffix] = d / f"v{suffix}"
    # a TorchScript module with the official names, and the buffers the
    # port builds itself (dropped on load)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in jinterop.export_vocos_state(jm.state_dict()).items()}
    state["head.istft.window"] = torch.hann_window(N_FFT)
    state["feature_extractor.mel_spec.mel_scale.fb"] = torch.ones(N_FFT // 2 + 1, N_MELS)
    save_torchscript_state(state, d / "v.pts")
    out[".pts"] = d / "v.pts"
    return jm, d / "v.ckpt", out


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_jax_written_vocos_loads_bit_equal_to_the_ckpt(files, suffix):
    _, ckpt, paths = files
    want = VocoderModel.from_pretrained(ckpt, device="cpu").generator.state_dict()
    got = VocoderModel.from_pretrained(paths[suffix], device="cpu", hop_length=HOP)
    assert set(got.generator.state_dict()) == set(want)
    for k, v in got.generator.state_dict().items():
        assert torch.equal(v, want[k]), k
    cfg = got.generator.config
    # torch Vocos's own math: erf GELU, magnitude clipped from above only
    assert cfg.gelu == "exact" and cfg.min_log_mag is None
    assert cfg.max_log_mag == pytest.approx(np.log(100.0))
    assert (got.features_config.n_fft, got.features_config.hop_length) == (N_FFT, HOP)
    assert not got.training


@pytest.mark.parametrize("fp16", [False, True])
def test_port_written_vocos_loads_in_jax_bit_equal(files, tmp_path, fp16):
    jm, ckpt, _ = files
    pm = VocoderModel.from_pretrained(ckpt, device="cpu")
    pinterop.save_torch_vocoder(pm, tmp_path / "port.pt", fp16=fp16)
    jinterop.save_torch_vocoder(jm, tmp_path / "jax.pt", fp16=fp16)
    ours, theirs = torch.load(tmp_path / "port.pt"), torch.load(tmp_path / "jax.pt")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():  # the same file as the JAX package writes
        assert v.dtype == ours[k].dtype and torch.equal(ours[k], v), k
    if fp16:
        return
    loaded = jinterop.load_torch_vocoder(tmp_path / "port.pt", hop_length=HOP)
    want = {k: v for k, v in jax_flat(jm).items() if k.startswith("generator.")}
    got = {k: v for k, v in jax_flat(loaded).items() if k.startswith("generator.")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_and_jax_load_one_pts_to_the_same_waveform(files):
    """The same ``.pts`` through both packages' loaders and generators."""
    _, _, paths = files
    pm = VocoderModel.from_pretrained(paths[".pts"], device="cpu", hop_length=HOP)
    jm = jinterop.load_torch_vocoder(paths[".pts"], hop_length=HOP)
    mel = np.random.RandomState(0).randn(2, 12, N_MELS).astype(np.float32)
    got = pm.infer(torch.from_numpy(mel)).numpy()
    want = np.asarray(jm.infer(mel))
    assert got.shape == want.shape == (2, 12 * HOP)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("fault", ["missing", "extra_block", "pickled_module", "no_backbone"])
def test_what_is_not_a_vocos_generator_is_refused(files, tmp_path, fault):
    jm, _, paths = files
    state = torch.load(paths[".pt"])
    path = tmp_path / "bad.pt"
    if fault == "missing":
        del state["backbone.convnext.1.gamma"]
    elif fault == "extra_block":
        state["backbone.convnext.3.gamma"] = state["backbone.convnext.1.gamma"]
    elif fault == "no_backbone":
        state = {"model.weight": torch.zeros(3)}
    if fault == "pickled_module":
        torch.save(torch.nn.Linear(2, 2), path)
        match = "Pickled torch modules are not loaded"
    else:
        torch.save(state, path)
        match = "Vocos"
    with pytest.raises(ValueError, match=match):
        VocoderModel.from_pretrained(path, device="cpu")


def test_convert_torch_checkpoint_maps_a_state_dict(files):
    """The trainer's warm-start hook: the same tensors and config as the
    loader, the mel contract from the given config."""
    _, _, paths = files
    state = torch.load(paths[".pt"])
    config, flat = VocoderModel.convert_torch_checkpoint(
        {"features": {"hop_length": HOP, "sample_rate": 16000}}, state)
    loaded = VocoderModel.from_pretrained(paths[".pt"], device="cpu", hop_length=HOP)
    assert set(flat) == {k for k in loaded.state_dict() if k.startswith("generator.")}
    for k, v in loaded.state_dict().items():
        if k.startswith("generator."):
            np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    assert config["generator"]["num_layers"] == 2 and config["features"]["sample_rate"] == 16000


def test_synthesize_cli_takes_a_pts_vocoder(tmp_path):
    """A ``.pts`` at the reference's mel contract (n_fft 1024, hop 256)."""
    from test_torch_port_export import TINY64, VOCODER, make_synth

    from isp_tts_tpu_torch import synthesize
    from isp_tts_tpu_torch.config import build_config

    synth = make_synth(TINY64)
    synth.model.save_pretrained(tmp_path / "m.ckpt")
    voc = VocoderModel(build_config(VocoderModel.Config, VOCODER))
    save_torchscript_state({k: torch.from_numpy(v) for k, v in
                            pinterop.export_vocos_state(voc.state_dict()).items()},
                           tmp_path / "v.pts")
    out = tmp_path / "out.wav"
    synthesize.main(["--checkpoint", str(tmp_path / "m.ckpt"), "--text", "birch canoe.",
                     "--output", str(out), "--vocoder", str(tmp_path / "v.pts"),
                     "--steps", "2", "--device", "cpu"])
    with wave.open(str(out)) as w:
        assert w.getnchannels() == 1 and w.getnframes() % 256 == 0 and w.getnframes() > 0
