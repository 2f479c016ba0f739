"""Audio features: magnitude STFT, slaney mel filterbank, log compression.

Counterpart of ``isp_tts_tpu/ops/audio.py``: magnitude STFT with an
explicit ``(n_fft - hop) / 2`` zero pad and no centering, a periodic Hann
window centred in the FFT frame, the slaney-scale slaney-norm filterbank and
``log(clamp(x, 1e-5))``. The filterbank is built in numpy in float64 and cast
to float32, exactly as the JAX package builds it; :func:`device_constant`
copies such host constants to a device once per (geometry, device).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _device_constant(fn, args: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def device_constant(fn, *args, device: torch.device | str) -> torch.Tensor:
    """``fn(*args)`` (a numpy array from a cached host function) as a tensor
    on ``device``, copied there once per (function, arguments, device)."""
    return _device_constant(fn, args, torch.device(device))


def hann_window(win_length: int, dtype=torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames, frame_length) overlapping frames,
    n_frames = (n - frame_length) // hop + 1 (a strided view)."""
    if x.shape[-1] < frame_length:
        return x.new_zeros(x.shape[:-1] + (0, frame_length))
    return x.unfold(-1, frame_length, hop_length)


def stft_magnitude(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                   win_length: int = 1024, pad: int | None = None) -> torch.Tensor:
    """Magnitude spectrogram, (..., n_samples) -> (..., n_freqs, n_frames)."""
    if pad is None:
        pad = (n_fft - hop_length) // 2
    frames = frame_signal(torch.nn.functional.pad(audio, (pad, pad)), n_fft, hop_length)
    win = hann_window(win_length, dtype=frames.dtype, device=frames.device)
    if win_length < n_fft:  # centre the window inside the FFT frame
        lpad = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (lpad, n_fft - win_length - lpad))
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    return spec.abs().transpose(-1, -2)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int = 1024, n_mels: int = 80,
                   f_min: float = 0.0, f_max: float | None = 8000.0,
                   norm: str | None = "slaney") -> np.ndarray:
    """Slaney-scale triangular mel filterbank, (n_mels, n_fft // 2 + 1) float32
    (torchaudio ``MelScale(norm='slaney', mel_scale='slaney')``)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)
    f_diff = np.diff(hz_pts)  # (n_mels + 1,)
    slopes = hz_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # (n_freqs, n_mels)
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.T.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, clip_val) * C)."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def log_mel_spectrogram(audio: torch.Tensor, sample_rate: int, n_fft: int = 1024,
                        hop_length: int = 256, win_length: int = 1024,
                        n_mels: int = 80, f_min: float = 0.0,
                        f_max: float | None = 8000.0) -> torch.Tensor:
    """(..., n_samples) -> (..., n_mels, n_frames) log-compressed slaney mel."""
    spec = stft_magnitude(audio, n_fft, hop_length, win_length)
    fb = device_constant(mel_filterbank, sample_rate, n_fft, n_mels, f_min, f_max,
                         device=audio.device)
    return dynamic_range_compression(torch.einsum("mf,...ft->...mt", fb, spec))
