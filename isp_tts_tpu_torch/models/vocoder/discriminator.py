"""GAN discriminators for vocoder training: multi-period + multi-resolution.

Counterpart of ``isp_tts_tpu/models/vocoder/discriminator.py``:

- :class:`PeriodDiscriminator` (HiFi-GAN): the waveform folded to an
  (S / p, p) grid for each period p, judged by (5, 1)-kernel strided 2-D
  convolutions;
- :class:`ResolutionDiscriminator` (UnivNet/Vocos): log1p of the STFT
  magnitude at one resolution (the matmul STFT of
  :mod:`isp_tts_tpu_torch.ops.vocoder`, in float32), judged by 2-D
  convolutions with frequency as height and time as width.

Every convolution is weight-normalised (:class:`WNConv`): kernel =
g * v / sqrt(sum(v^2) + 1e-12), the sum over every axis but the output
channel, in float32. The port is NCHW with OIHW kernels where the JAX
package is NHWC with HWIO ones; the parameters keep the JAX names (``v``,
``g``, ``bias``) and ``v``'s axes are permuted on the way in and out
(``JAX_LAYOUTS``), so a checkpoint maps one to one. The convolutions are
cuDNN's; under a bf16 autocast they run in bf16 as the JAX compute policy
runs them, the weight norm and the STFT in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.vocoder import _stft_matmul


@dataclass
class VocoderDiscriminatorConfig:
    periods: tuple = (2, 3, 5, 7, 11)
    #: (n_fft, hop_length) per spectrogram resolution; win = n_fft
    resolutions: tuple = ((1024, 256), (2048, 512), (512, 128))
    mpd_channels: tuple = (32, 128, 512, 1024)
    mrd_channels: int = 32
    leaky_slope: float = 0.1


class WNConv(nn.Module):
    """Weight-normalised 2-D convolution, NCHW in and out; ``v`` is
    (out, in, kh, kw), the JAX package's (kh, kw, in, out) permuted."""

    #: parameter -> the permutation of its axes into the JAX layout
    JAX_LAYOUTS = {"v": (2, 3, 1, 0)}

    def __init__(self, in_features: int, out_features: int, kernel_size: tuple,
                 strides: tuple = (1, 1)):
        super().__init__()
        kh, kw = kernel_size
        # he_normal over the (kh, kw, in) fan-in, as the JAX initialiser
        v = torch.randn(out_features, in_features, kh, kw) * math.sqrt(
            2.0 / (in_features * kh * kw))
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt((v * v).sum(dim=(1, 2, 3))))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.strides = tuple(strides)
        self.padding = (kh // 2, kw // 2)

    def kernel(self) -> torch.Tensor:
        v = self.v.float()
        norm = torch.sqrt((v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        return v / norm * self.g.float()[:, None, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel(), self.bias, self.strides, self.padding)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels: tuple, slope: float):
        super().__init__()
        self.period = int(period)
        self.slope = float(slope)
        convs, c_in = [], 1
        for c_out in channels:
            convs.append(WNConv(c_in, c_out, (5, 1), (3, 1)))
            c_in = c_out
        convs.append(WNConv(c_in, c_in, (5, 1), (1, 1)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv(c_in, 1, (3, 1), (1, 1))

    def forward(self, audio: torch.Tensor):
        """(B, S) -> (logits (B, n), features [(B, C, H, W)])."""
        B, S = audio.shape
        p = self.period
        pad = (-S) % p
        if pad:
            mode = "reflect" if pad < S else "constant"
            audio = F.pad(audio[:, None], (0, pad), mode=mode)[:, 0]
        x = audio.reshape(B, 1, (S + pad) // p, p)
        features = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.slope)
            features.append(x)
        x = self.conv_post(x)
        features.append(x)
        return x.reshape(B, -1), features


def _log_magnitude(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, S) -> (B, 1, F, T) log1p STFT magnitude, in float32."""
    with torch.autocast(audio.device.type, enabled=False):
        re, im = _stft_matmul(audio.float(), n_fft, hop, n_fft, (n_fft - hop) // 2)
        return torch.log1p(torch.sqrt(re * re + im * im + 1e-9))[:, None]


class ResolutionDiscriminator(nn.Module):
    def __init__(self, n_fft: int, hop: int, channels: int, slope: float):
        super().__init__()
        self.n_fft, self.hop, self.slope = int(n_fft), int(hop), float(slope)
        c = channels
        self.convs = nn.ModuleList([
            WNConv(1, c, (3, 9), (1, 1)),
            WNConv(c, c, (3, 9), (1, 2)),
            WNConv(c, c, (3, 9), (1, 2)),
            WNConv(c, c, (3, 9), (1, 2)),
            WNConv(c, c, (3, 3), (1, 1)),
        ])
        self.conv_post = WNConv(c, 1, (3, 3), (1, 1))

    def forward(self, audio: torch.Tensor):
        """(B, S) -> (logits (B, n), features [(B, C, F, T)])."""
        x = _log_magnitude(audio, self.n_fft, self.hop)
        features = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.slope)
            features.append(x)
        x = self.conv_post(x)
        features.append(x)
        return x.reshape(audio.shape[0], -1), features


class VocoderDiscriminator(nn.Module):
    """The ensemble: each sub-discriminator's logits and feature pyramid."""

    Config = VocoderDiscriminatorConfig

    def __init__(self, config: VocoderDiscriminatorConfig):
        super().__init__()
        cfg = self.config = config
        self.period_discs = nn.ModuleList([
            PeriodDiscriminator(p, tuple(cfg.mpd_channels), cfg.leaky_slope)
            for p in cfg.periods])
        self.resolution_discs = nn.ModuleList([
            ResolutionDiscriminator(n_fft, hop, cfg.mrd_channels, cfg.leaky_slope)
            for n_fft, hop in cfg.resolutions])

    def forward(self, audio: torch.Tensor):
        logits, features = [], []
        for disc in (*self.period_discs, *self.resolution_discs):
            lg, ft = disc(audio)
            logits.append(lg)
            features.append(ft)
        return logits, features
