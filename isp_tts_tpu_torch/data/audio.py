"""WAV read and write: the native decoder, and the standard library's
``wave`` module.

Counterpart of ``isp_tts_tpu/data/audio.py``: 8-, 16-, 24- and 32-bit PCM
and float32 in (float32 natively only), 16-bit PCM out; mono downmix and
resampling on load. :func:`load_audio` and :func:`load_audio_batch` decode
through the native C++ library (:mod:`isp_tts_tpu_torch.native`, the batch
on its thread pool), bit-equal to :func:`read_wav`; a build or load failure
raises. The Python reader reads a file only when the caller asks
(``native=False``, or ``ISP_TTS_TPU_NATIVE=0``) or when the native parser
refuses the file's codec, as in the JAX package. ``DECODED`` counts the
files each reader decoded. Resampling (only on a rate mismatch) is scipy's
``resample_poly``, imported when it is needed.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """A WAV file -> (float32 samples in [-1, 1] of shape (C, N), rate)."""
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif sampwidth == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    return x.reshape(-1, n_channels).T, sr


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono (N,) or (C, N) float32 [-1, 1] audio as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    pcm = np.clip(audio.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def wav_duration(path: str | Path) -> float:
    """Duration in seconds from the WAV header (no sample decode)."""
    with wave.open(str(path), "rb") as w:
        return w.getnframes() / float(w.getframerate())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's ``resample_poly``, as in the JAX package)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


#: files decoded by each reader since the counts were last set to 0
DECODED = {"native": 0, "python": 0}


def _python_mono(path) -> tuple[np.ndarray, int]:
    x, sr = read_wav(path)
    DECODED["python"] += 1
    return (x.mean(axis=0) if x.shape[0] > 1 else x[0]), sr


def _native_mono(path) -> tuple[np.ndarray, int]:
    from .. import native

    try:
        mono, sr = native.decode_wav_mono(path)
    except native.WavDecodeError as e:
        if set(e.codes.values()) != {native.ERR_CODEC}:
            raise
        # a codec the native parser does not take: the Python reader reads
        # the file or raises its own error, as in the JAX package
        return _python_mono(path)
    DECODED["native"] += 1
    return mono, sr


def _finish(mono: np.ndarray, sr: int, sample_rate: int | None) -> np.ndarray:
    if sample_rate is not None and sr != sample_rate:
        mono = resample(mono, sr, sample_rate)
    return np.ascontiguousarray(mono, dtype=np.float32)


def _use_native(native: bool | None) -> bool:
    from .. import native as _native

    return _native.enabled() if native is None else bool(native)


def load_audio(path: str | Path, sample_rate: int | None = None,
               native: bool | None = None) -> np.ndarray:
    """A WAV file -> mono float32 (N,), resampled to ``sample_rate`` if
    given. ``native`` False reads with the Python reader (None: the
    native decoder unless ``ISP_TTS_TPU_NATIVE=0``)."""
    mono, sr = _native_mono(path) if _use_native(native) else _python_mono(path)
    return _finish(mono, sr, sample_rate)


def load_audio_batch(paths, sample_rate: int | None = None,
                     native: bool | None = None) -> list[np.ndarray]:
    """:func:`load_audio` of each path, the decode of the whole batch on the
    native thread pool; when a file fails there, each file is read again
    alone (a refused codec then goes to the Python reader)."""
    if not _use_native(native):
        return [load_audio(p, sample_rate, native=False) for p in paths]
    from .. import native as _native

    try:
        decoded = _native.decode_wav_batch(paths)
    except _native.WavDecodeError:
        return [load_audio(p, sample_rate, native=True) for p in paths]
    DECODED["native"] += len(decoded)
    return [_finish(mono, sr, sample_rate) for mono, sr in decoded]
