"""Batched audio front end: padded raw audio -> (mel, pitch, energy).

Counterpart of ``isp_tts_tpu/ops/frontend.py``: one pass over a padded
batch on the batch's device (the card, for a dataset on CUDA): magnitude
STFT, slaney log-mel, ``log1p`` energy, and YIN with the frame-count
matching ``f_min = 2 * int(sr / win_length)``. A YIN track one frame short
of the mel is zero-padded, as there (and as the per-utterance providers
do). Frames past each row's length are zeroed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .audio import device_constant, frame_energy, mel_filterbank, stft_magnitude
from .pitch import yin_pitch


class FrontendFeatures(NamedTuple):
    mel: torch.Tensor  # (B, frames, n_mels) log-mel, channel-last
    pitch: torch.Tensor  # (B, frames) standardised F0
    energy: torch.Tensor  # (B, frames) log1p L2
    mel_lens: torch.Tensor  # (B,) valid frame counts


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = 8000.0
    pitch_f_max: float = 800.0
    pitch_threshold: float = 0.15


@torch.no_grad()
def extract_features(audio: torch.Tensor, audio_lens: torch.Tensor,
                     config: FrontendConfig = FrontendConfig(),
                     pitch_mean: float = 0.0, pitch_std: float = 1.0) -> FrontendFeatures:
    """audio (B, n_samples) float32, zero-padded; audio_lens (B,) valid
    sample counts. Everything runs on ``audio``'s device."""
    c = config
    spec = stft_magnitude(audio, c.n_fft, c.hop_length, c.win_length)  # (B, F, T)
    fb = device_constant(mel_filterbank, c.sample_rate, c.n_fft, c.n_mels, c.f_min,
                         c.f_max, device=audio.device)
    mel = torch.log(torch.clamp(torch.einsum("mf,bft->btm", fb, spec), min=1e-5))
    energy = frame_energy(spec)

    yin_fmin = 2 * int(c.sample_rate / c.win_length)
    pad = (c.win_length - c.hop_length) // 2
    pitch = yin_pitch(F.pad(audio, (pad, pad)), c.sample_rate, yin_fmin, c.pitch_f_max,
                      c.hop_length, c.pitch_threshold)
    n_frames = mel.shape[1]
    if pitch.shape[1] < n_frames:
        pitch = F.pad(pitch, (0, n_frames - pitch.shape[1]))
    pitch = (pitch[:, :n_frames] - pitch_mean) / pitch_std

    pad_total = 2 * ((c.n_fft - c.hop_length) // 2)
    mel_lens = torch.clamp((audio_lens.long() + pad_total - c.n_fft) // c.hop_length + 1,
                           0, n_frames).to(torch.int32)
    mask = torch.arange(n_frames, device=audio.device)[None, :] < mel_lens[:, None]
    return FrontendFeatures(mel=mel * mask[..., None], pitch=pitch * mask,
                            energy=energy * mask, mel_lens=mel_lens)


def bucket_audio(batch_audio: list, multiple: int = 16384) -> tuple[np.ndarray, np.ndarray]:
    """Pad 1-D arrays to one shared length, a multiple of ``multiple``."""
    lens = np.asarray([len(a) for a in batch_audio], np.int32)
    bucket = -(-int(lens.max()) // multiple) * multiple
    out = np.zeros((len(batch_audio), bucket), np.float32)
    for i, a in enumerate(batch_audio):
        out[i, : len(a)] = a
    return out, lens
