"""Mel -> waveform: Griffin-Lim and the inverse STFT of the neural vocoder.

Counterpart of ``isp_tts_tpu/ops/vocoder.py``, in two families as there:

- the FFT family (``istft``, ``griffin_lim``, ``mel_to_audio``) on
  ``torch.fft``, with complex phases;
- the matmul family (``istft_matmul``, ``griffin_lim_matmul``,
  ``log_mel_matmul``, ``mel_to_audio_tpu``; names as in the JAX package):
  the real DFT as products with precomputed cos/sin bases, overlap-add as
  n_fft / hop shifted adds, phases carried as (cos, sin) pairs. The neural
  vocoder's head and the Synthesizer's Griffin-Lim run on it.

The host constants (``_dft_bases``, ``_synth_window``, ``_ola_norm``,
``_mel_pinv``) are built with the JAX package's numpy code, in float64 and
cast to float32, so both packages use the same bits; they are copied to a
device once (:func:`~isp_tts_tpu_torch.ops.audio.device_constant`).

JAX's random start phases cannot be drawn in torch: ``griffin_lim*`` and
``mel_to_audio*`` take the ``angles`` to start from, and otherwise draw them
uniform in [-pi, pi) from a ``torch.Generator`` seeded 0 (JAX's default is
``PRNGKey(0)``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .audio import device_constant, dynamic_range_compression, frame_signal, mel_filterbank


@functools.lru_cache(maxsize=4)
def _mel_pinv(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
              f_max: float | None) -> np.ndarray:
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)  # (mels, freqs)
    return np.linalg.pinv(fb).astype(np.float32)  # (freqs, mels)


def mel_to_linear(log_mel: torch.Tensor, sample_rate: int, n_fft: int = 1024,
                  f_min: float = 0.0, f_max: float | None = 8000.0) -> torch.Tensor:
    """(..., frames, n_mels) log-mel -> (..., n_freqs, frames) magnitude."""
    pinv = device_constant(_mel_pinv, sample_rate, n_fft, log_mel.shape[-1], f_min, f_max,
                           device=log_mel.device)
    mag = torch.einsum("fm,...tm->...ft", pinv, torch.exp(log_mel))
    return torch.clamp(mag, min=0.0)


@functools.lru_cache(maxsize=8)
def _synth_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of ``win_length`` centred in the ``n_fft`` frame (the
    analysis window of ``ops/audio.stft_magnitude``)."""
    n = np.arange(win_length, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    elif win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    return win.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _ola_norm(T: int, n_fft: int, hop_length: int, win_length: int) -> np.ndarray:
    """The window-square overlap-add normaliser of T frames."""
    win = _synth_window(win_length, n_fft)
    out_len = n_fft + hop_length * (T - 1)
    norm = np.zeros((out_len,), np.float64)
    idx = np.arange(T)[:, None] * hop_length + np.arange(n_fft)[None, :]
    np.add.at(norm, idx.reshape(-1), np.tile((win * win).astype(np.float64), T))
    return norm.astype(np.float32)


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    return device_constant(_synth_window, win_length, n_fft, device=device)


def _crop(audio: torch.Tensor, pad: int) -> torch.Tensor:
    return audio[..., pad:audio.shape[-1] - pad] if pad else audio


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          win_length: int = 1024) -> torch.Tensor:
    """Inverse STFT with overlap-add, (..., n_freqs, frames) complex -> (..., n)."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)  # (..., T, n_fft)
    frames = frames * _window(win_length, n_fft, frames.device)
    lead, T = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop_length * (T - 1)
    # overlap-add as fold: frame t lands at t * hop
    sig = F.fold(frames.reshape(-1, T, n_fft).transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop_length)).reshape(*lead, out_len)
    norm = device_constant(_ola_norm, T, n_fft, hop_length, win_length, device=sig.device)
    return sig / torch.clamp(norm, min=1e-8)


def _random_angles(shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=gen, device=device) * (2 * math.pi) - math.pi


def griffin_lim(magnitude: torch.Tensor, n_iter: int = 32, n_fft: int = 1024,
                hop_length: int = 256, win_length: int = 1024,
                angles: torch.Tensor | None = None) -> torch.Tensor:
    """Phase recovery from (..., n_freqs, frames) magnitudes, complex FFTs."""
    pad = (n_fft - hop_length) // 2
    if angles is None:
        angles = _random_angles(magnitude.shape, magnitude.device)
    phase = torch.polar(torch.ones_like(angles, dtype=torch.float32), angles.float())
    for _ in range(n_iter):
        audio = _crop(istft(magnitude * phase, n_fft, hop_length, win_length), pad)
        # re-analyse with the synthesis padding so the frames line up
        spec = _stft_complex(audio, n_fft, hop_length, win_length, pad)
        spec = spec[..., : magnitude.shape[-1]]
        phase = spec / torch.clamp(spec.abs(), min=1e-8)
    return _crop(istft(magnitude * phase, n_fft, hop_length, win_length), pad)


def _stft_complex(audio, n_fft, hop_length, win_length, pad):
    frames = frame_signal(F.pad(audio, (pad, pad)), n_fft, hop_length)
    spec = torch.fft.rfft(frames * _window(win_length, n_fft, frames.device), n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def mel_to_audio(log_mel: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024, f_min: float = 0.0,
                 f_max: float | None = 8000.0, n_iter: int = 32, power: float = 1.2,
                 angles: torch.Tensor | None = None) -> torch.Tensor:
    """Griffin-Lim vocoder: (..., frames, n_mels) log-mel -> waveform.
    ``power`` > 1 sharpens the magnitudes before phase recovery."""
    mag = mel_to_linear(log_mel, sample_rate, n_fft, f_min, f_max) ** power
    return griffin_lim(mag, n_iter, n_fft, hop_length, win_length, angles=angles)


# ---------------------------------------------------------------------------
# the matmul family: real DFT products, shifted-add overlap-add


@functools.lru_cache(maxsize=2)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, ...]:
    """(fwd_re, fwd_im, inv_re, inv_im): x @ fwd -> (re, im) of rfft(x);
    re @ inv_re + im @ inv_im -> irfft."""
    eye = np.eye(n_fft, dtype=np.float64)
    spec = np.fft.rfft(eye, axis=-1)  # (n_fft, n_freqs)
    fwd_re = spec.real.astype(np.float32)
    fwd_im = spec.imag.astype(np.float32)
    n_freqs = spec.shape[-1]
    eye_f = np.eye(n_freqs, dtype=np.float64)
    inv_re = np.fft.irfft(eye_f, n=n_fft, axis=-1).astype(np.float32)
    inv_im = np.fft.irfft(1j * eye_f, n=n_fft, axis=-1).astype(np.float32)
    return fwd_re, fwd_im, inv_re, inv_im


def _dft_basis(n_fft: int, which: int) -> np.ndarray:
    return _dft_bases(n_fft)[which]


def _basis(n_fft: int, which: int, device) -> torch.Tensor:
    """Basis ``which`` of :func:`_dft_bases` on ``device``."""
    return device_constant(_dft_basis, n_fft, which, device=device)


def _ola_dense(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (..., T, n_fft) -> (..., n_fft + hop * (T - 1)) as the sum
    of n_fft / hop shifted views, added in the JAX package's order."""
    *lead, T, n_fft = frames.shape
    if n_fft % hop_length:
        raise ValueError(f"n_fft {n_fft} is not a multiple of hop {hop_length}")
    out = frames.new_zeros((*lead, n_fft + hop_length * (T - 1)))
    for j in range(n_fft // hop_length):
        piece = frames[..., :, j * hop_length:(j + 1) * hop_length].reshape(*lead, T * hop_length)
        out[..., j * hop_length: j * hop_length + T * hop_length] += piece
    return out


def istft_matmul(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024) -> tuple[torch.Tensor, int]:
    """Real-pair inverse STFT: (..., n_freqs, T) x2 -> ((..., samples), n)."""
    dev = spec_re.device
    frames = (spec_re.transpose(-1, -2) @ _basis(n_fft, 2, dev)
              + spec_im.transpose(-1, -2) @ _basis(n_fft, 3, dev))
    frames = frames * _window(win_length, n_fft, dev)
    T = frames.shape[-2]
    out_len = n_fft + hop_length * (T - 1)
    sig = _ola_dense(frames, hop_length)
    norm = device_constant(_ola_norm, T, n_fft, hop_length, win_length, device=dev)
    return sig / torch.clamp(norm, min=1e-8), out_len


def _stft_matmul(audio: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                 pad: int):
    dev = audio.device
    frames = (frame_signal(F.pad(audio, (pad, pad)), n_fft, hop_length)
              * _window(win_length, n_fft, dev))
    re = (frames @ _basis(n_fft, 0, dev)).transpose(-1, -2)  # (..., F, T)
    im = (frames @ _basis(n_fft, 1, dev)).transpose(-1, -2)
    return re, im


def griffin_lim_matmul(magnitude: torch.Tensor, n_iter: int = 32, n_fft: int = 1024,
                       hop_length: int = 256, win_length: int = 1024,
                       angles: torch.Tensor | None = None) -> torch.Tensor:
    """Griffin-Lim with no complex dtypes or FFTs: :func:`griffin_lim`'s
    algorithm with the phases carried as (cos, sin)."""
    pad = (n_fft - hop_length) // 2
    if angles is None:
        angles = _random_angles(magnitude.shape, magnitude.device)
    angles = angles.float()
    ph_re, ph_im = torch.cos(angles), torch.sin(angles)
    T = magnitude.shape[-1]
    for _ in range(n_iter):
        audio, _ = istft_matmul(magnitude * ph_re, magnitude * ph_im, n_fft, hop_length,
                                win_length)
        re, im = _stft_matmul(_crop(audio, pad), n_fft, hop_length, win_length, pad)
        re, im = re[..., :T], im[..., :T]
        mag = torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        ph_re, ph_im = re / mag, im / mag
    audio, _ = istft_matmul(magnitude * ph_re, magnitude * ph_im, n_fft, hop_length,
                            win_length)
    return _crop(audio, pad)


def log_mel_matmul(audio: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
                   hop_length: int = 256, win_length: int = 1024, n_mels: int = 80,
                   f_min: float = 0.0, f_max: float | None = 8000.0,
                   eps: float = 1e-12) -> torch.Tensor:
    """(..., samples) -> (..., frames, n_mels) log-mel through the matmul
    DFT: the data providers' STFT contract, ``eps`` inside the magnitude's
    square root so its gradient stays finite at silent bins."""
    if win_length != n_fft:
        raise ValueError("log_mel_matmul requires win_length == n_fft")
    pad = (n_fft - hop_length) // 2
    re, im = _stft_matmul(audio, n_fft, hop_length, win_length, pad)  # (..., F, T)
    mag = torch.sqrt(re * re + im * im + eps)
    fb = device_constant(mel_filterbank, sample_rate, n_fft, n_mels, f_min, f_max,
                         device=audio.device)
    return dynamic_range_compression(torch.einsum("mf,...ft->...tm", fb, mag))


def mel_to_audio_tpu(log_mel: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
                     hop_length: int = 256, win_length: int = 1024, f_min: float = 0.0,
                     f_max: float | None = 8000.0, n_iter: int = 32, power: float = 1.2,
                     angles: torch.Tensor | None = None) -> torch.Tensor:
    """The matmul-DFT Griffin-Lim vocoder (named as in the JAX package):
    :func:`mel_to_audio` without complex dtypes."""
    mag = mel_to_linear(log_mel, sample_rate, n_fft, f_min, f_max) ** power
    return griffin_lim_matmul(mag, n_iter, n_fft, hop_length, win_length, angles=angles)
