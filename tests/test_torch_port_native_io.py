"""The port's native (C++) WAV decode, on the CPU: the port's copy of
``test_native_io.py``.

Bit-equality with the port's Python reader (PCM 8/16/24/32 bits, stereo
mixdown), float32 and WAVE_FORMAT_EXTENSIBLE, a batch equal to single
decodes at every thread count, the error surface, the Python reader taken
only when asked (``native=False``) or for a refused codec, resampling, the
AudioProvider's batch, the equality with the JAX package's decoder, and a
failed build that raises instead of falling back.
"""

import numpy as np
import pytest

from isp_tts_tpu import native as jnative
from isp_tts_tpu_torch import native
from isp_tts_tpu_torch.data import audio as paudio
from isp_tts_tpu_torch.data.audio import load_audio, load_audio_batch, read_wav, write_wav
from test_native_io import _write_float32, _write_pcm


@pytest.mark.parametrize("sampwidth,lo,hi", [
    (1, -128, 127), (2, -32768, 32767), (3, -(1 << 23), (1 << 23) - 1),
    (4, -(1 << 31), (1 << 31) - 1)])
def test_pcm_widths_match_python_reader_exactly(tmp_path, sampwidth, lo, hi):
    rng = np.random.default_rng(sampwidth)
    data = rng.integers(lo, hi, size=777, endpoint=True)
    data[:2] = (lo, hi)
    p = tmp_path / "t.wav"
    _write_pcm(p, data, sampwidth)
    ref, sr_ref = read_wav(p)
    got, sr = native.decode_wav_mono(p)
    assert sr == sr_ref == 16000
    np.testing.assert_array_equal(got, ref[0])
    np.testing.assert_array_equal(got, jnative.decode_wav_mono(p)[0])


def test_stereo_mixdown_matches_python(tmp_path):
    rng = np.random.default_rng(7)
    p = tmp_path / "st.wav"
    _write_pcm(p, rng.integers(-32768, 32767, size=500 * 2, endpoint=True), 2, channels=2)
    got, _ = native.decode_wav_mono(p)
    np.testing.assert_array_equal(got, read_wav(p)[0].mean(axis=0).astype(np.float32))
    np.testing.assert_array_equal(load_audio(p), load_audio(p, native=False))


@pytest.mark.parametrize("extensible", [False, True])
def test_float32_and_extensible(tmp_path, extensible):
    data = np.random.default_rng(3).standard_normal(300).astype(np.float32) * 0.5
    p = tmp_path / "f.wav"
    _write_float32(p, data, extensible=extensible)
    got, sr = native.decode_wav_mono(p)
    assert sr == 16000
    np.testing.assert_array_equal(got, data)


def test_batch_equals_single_and_thread_counts(tmp_path):
    rng = np.random.default_rng(11)
    paths = []
    for i in range(9):
        p = tmp_path / f"b{i}.wav"
        _write_pcm(p, rng.integers(-32768, 32767, size=100 + 37 * i), 2)
        paths.append(p)
    singles = [native.decode_wav_mono(p) for p in paths]
    for n_threads in (0, 1, 3, 16):
        batch = native.decode_wav_batch(paths, n_threads=n_threads)
        assert len(batch) == len(paths)
        for (bx, bsr), (sx, ssr) in zip(batch, singles):
            assert bsr == ssr
            np.testing.assert_array_equal(bx, sx)


def test_error_surface(tmp_path):
    missing = tmp_path / "nope.wav"
    with pytest.raises(ValueError, match="missing"):
        native.decode_wav_mono(missing)
    with pytest.raises(ValueError, match="missing"):
        load_audio(missing)  # only a refused codec goes to the Python reader
    junk = tmp_path / "junk.wav"
    junk.write_bytes(b"RIFFxxxxJUNK" + b"\x00" * 64)
    with pytest.raises(ValueError, match="RIFF/WAVE"):
        native.decode_wav_mono(junk)
    ok = tmp_path / "ok.wav"
    _write_pcm(ok, np.arange(-5, 5), 2)
    with pytest.raises(native.WavDecodeError, match="batch decode failed") as e:
        native.decode_wav_batch([ok, missing])
    assert e.value.codes == {str(missing): native.ERR_OPEN}
    with pytest.raises(ValueError, match="missing"):
        load_audio_batch([ok, missing])


def test_python_reader_only_when_asked(tmp_path, monkeypatch):
    p = tmp_path / "t.wav"
    write_wav(p, np.sin(np.linspace(0, 40, 4000, dtype=np.float32))[None], 16000)
    paudio.DECODED.update(native=0, python=0)
    via_native = load_audio(p)
    batch = load_audio_batch([p, p])
    assert paudio.DECODED == {"native": 3, "python": 0}
    via_python = load_audio(p, native=False)
    np.testing.assert_array_equal(via_native, via_python)
    np.testing.assert_array_equal(batch[1], via_python)
    monkeypatch.setenv("ISP_TTS_TPU_NATIVE", "0")
    np.testing.assert_array_equal(load_audio_batch([p])[0], via_python)
    assert paudio.DECODED == {"native": 3, "python": 2}


def test_load_audio_batch_resamples_like_single(tmp_path):
    p = tmp_path / "sr.wav"
    write_wav(p, np.sin(np.linspace(0, 60, 8000, dtype=np.float32))[None], 16000)
    single = load_audio(p, sample_rate=8000)
    (batched,) = load_audio_batch([p], sample_rate=8000)
    np.testing.assert_array_equal(batched, single)
    np.testing.assert_array_equal(single, load_audio(p, sample_rate=8000, native=False))


def test_audio_provider_load_batch(tmp_path):
    from isp_tts_tpu_torch.data.providers import AudioProvider

    prov = AudioProvider(sample_rate=16000)
    paths = []
    for i in range(3):
        p = tmp_path / f"p{i}.wav"
        write_wav(p, np.sin(np.linspace(0, 10 + i, 2000, dtype=np.float32))[None], 16000)
        paths.append(p)
    for p, got in zip(paths, prov.load_batch(paths)):
        np.testing.assert_array_equal(got, prov(p))


def test_unsupported_codec_falls_back_to_python_error(tmp_path):
    import struct

    p = tmp_path / "adpcm.wav"
    payload = b"\x00" * 32
    fmt = struct.pack("<HHIIHH", 2, 1, 8000, 8000, 1, 4)
    riff = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt +
            b"data" + struct.pack("<I", len(payload)) + payload)
    p.write_bytes(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    with pytest.raises(ValueError, match="codec"):
        native.decode_wav_mono(p)
    with pytest.raises(Exception) as e:  # the wave module's own refusal
        load_audio(p)
    assert not isinstance(e.value, native.WavDecodeError)
    with pytest.raises(Exception) as e:
        load_audio_batch([p])
    assert not isinstance(e.value, native.WavDecodeError)


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "wavio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    p = tmp_path / "t.wav"
    write_wav(p, np.zeros((1, 100), np.float32), 16000)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_audio(p)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_audio_batch([p])
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(FileNotFoundError("g++")))
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.lib()
    assert load_audio(p, native=False).shape == (100,)  # asked for: the Python reader
