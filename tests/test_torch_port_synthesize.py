"""The port's synthesis CLI and WAV I/O against the JAX package's, on the CPU.

``python -m isp_tts_tpu_torch.synthesize`` runs here with ``--device cpu``
on both committed checkpoints, with the neural vocoder and with
Griffin-Lim: it writes a 22.05 kHz 16-bit mono WAV of frames x 256 samples,
and the tokens it synthesizes are the JAX CLI's for the same text.
"""

import wave

import numpy as np
import pytest

from isp_tts_tpu import synthesize as jsynthesize
from isp_tts_tpu.data.audio import read_wav as jread_wav
from isp_tts_tpu.data.audio import write_wav as jwrite_wav
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu_torch import synthesize
from isp_tts_tpu_torch.data.audio import read_wav, write_wav
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"
VOCODER = "docs/assets/scale_r5/vocoder_joint10k_r5.f16.ckpt"
TEXT = "Glue the sheet to the dark blue background!"


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_tokens():
    """The tokens the JAX CLI hands its model for TEXT (it stops there)."""
    seen = {}

    def spy(self, tokens, *args, **kwargs):
        seen["tokens"] = np.asarray(tokens)
        seen["max_dec_len"] = kwargs["max_dec_len"]
        raise _Stop

    real = JAcousticModel.infer
    JAcousticModel.infer = spy
    try:
        with pytest.raises(_Stop):
            jsynthesize.main(["--checkpoint", CKPT, "--text", TEXT, "--output", "/dev/null"])
    finally:
        JAcousticModel.infer = real
    return seen


@pytest.mark.parametrize("vocoder", [True, False])
def test_cli_writes_the_wav_of_the_jax_cli_tokens(tmp_path, monkeypatch, jax_tokens, vocoder):
    seen = {}
    real = AcousticModel.infer

    def spy(self, tokens, *args, **kwargs):
        mel, ad = real(self, tokens, *args, **kwargs)
        seen.update(tokens=tokens.numpy(), frames=int(ad.dec_lengths[0]),
                    max_dec_len=kwargs["max_dec_len"])
        return mel, ad

    monkeypatch.setattr(AcousticModel, "infer", spy)
    out = tmp_path / "out.wav"
    synthesize.main(["--checkpoint", CKPT, "--text", TEXT, "--output", str(out),
                     "--device", "cpu"] + (["--vocoder", VOCODER] if vocoder else []))
    np.testing.assert_array_equal(seen["tokens"], jax_tokens["tokens"])
    assert seen["max_dec_len"] == jax_tokens["max_dec_len"] == 2048
    assert 100 < seen["frames"] < 2048
    with wave.open(str(out), "rb") as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (22050, 2, 1)
        assert w.getnframes() == seen["frames"] * 256
    audio, sr = read_wav(out)
    assert sr == 22050 and audio.shape == (1, seen["frames"] * 256)
    peak = np.abs(audio).max()
    assert np.isfinite(audio).all() and 0.05 < peak <= 1.0
    if not vocoder:  # Griffin-Lim is peak-normalised to 0.95
        assert abs(peak - 0.95) < 1e-3


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_wav_io_matches_jax(tmp_path, width):
    rng = np.random.RandomState(width)
    audio = np.clip(0.5 * rng.randn(2, 300), -1, 1).astype(np.float32)
    path = tmp_path / "x.wav"
    if width == 2:
        write_wav(path, audio, 16000)
        jwrite_wav(tmp_path / "j.wav", audio, 16000)
        assert path.read_bytes() == (tmp_path / "j.wav").read_bytes()
    else:
        ints = rng.randint(0, 256, size=(300 * 2 * width,)).astype(np.uint8)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(ints.tobytes())
    got, sr = read_wav(path)
    ref, jsr = jread_wav(path)
    assert sr == jsr == 16000 and got.shape == ref.shape == (2, 300)
    np.testing.assert_array_equal(got, ref)
    write_wav(tmp_path / "mono.wav", audio[0], 22050)
    mono, _ = read_wav(tmp_path / "mono.wav")
    # write truncates to 1 LSB and scales by 32767, read by 32768: 2 LSB
    np.testing.assert_allclose(mono[0], audio[0], atol=2 / 32767)
