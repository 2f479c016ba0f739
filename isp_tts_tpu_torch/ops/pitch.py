"""YIN fundamental-frequency estimation on batched signals.

Counterpart of ``isp_tts_tpu/ops/pitch.py:yin_pitch`` (de Cheveigné &
Kawahara 2002, eqs. 6-8, with the vendored torch-yin's conventions): the
difference function from an FFT autocorrelation and energy cumsums, the
cumulative-mean-normalised difference, the first lag under ``threshold``
walked on to its local minimum, and 0 Hz for frames with no such lag. The
inherited quirk stays: a dip under the threshold at the first searched lag
reads as unvoiced, as there. Runs on whatever device ``signal`` is on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .audio import frame_signal


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def yin_pitch(signal: torch.Tensor, sample_rate: int, pitch_min: float,
              pitch_max: float, hop_length: int, threshold: float = 0.15) -> torch.Tensor:
    """(..., n_samples) audio -> (..., n_frames) F0 in Hz, 0 where unvoiced;
    n_frames = (n_samples - 2 * int(sr / pitch_min)) // hop + 1."""
    tau_min = int(sample_rate / pitch_max)
    tau_max = int(sample_rate / pitch_min)
    frames = frame_signal(signal, 2 * tau_max, hop_length)  # (..., T, W)
    fft_size = 2 * _next_pow2(2 * tau_max)
    spec = torch.fft.rfft(frames, n=fft_size, dim=-1)
    acorr = torch.fft.irfft(spec * spec.conj(), n=fft_size, dim=-1)[..., :tau_max]

    energy_csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    total_energy = energy_csum[..., -1:]
    tail_energy = energy_csum.flip(-1)[..., :tau_max] - energy_csum[..., :tau_max]
    d = total_energy + tail_energy - 2.0 * acorr  # (..., T, tau_max)

    d1 = d[..., 1:]
    taus = torch.arange(1, tau_max, dtype=d.dtype, device=d.device)
    cmndf = d1 * taus / torch.clamp(torch.cumsum(d1, dim=-1), min=1e-5)
    cmndf = cmndf[..., tau_min:]
    n_lags = cmndf.shape[-1]

    below = (cmndf < threshold).to(torch.int8)
    first_below = torch.argmax(below, dim=-1, keepdim=True)  # first True, else 0
    first_below = torch.where(first_below > 0, first_below,
                              torch.full_like(first_below, tau_max))
    beyond = torch.arange(n_lags, device=d.device) >= first_below
    rising = F.pad(torch.diff(cmndf, dim=-1) >= 0.0, (0, 1), value=True)
    tau = torch.argmax((beyond & rising).to(torch.int8), dim=-1)

    freq = sample_rate / (tau + tau_min + 1).to(signal.dtype)
    return torch.where(tau > 0, freq, torch.zeros_like(freq))
