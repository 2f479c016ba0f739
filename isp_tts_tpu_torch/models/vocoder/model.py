"""The Vocos-architecture neural vocoder: log-mel -> waveform.

Counterpart of ``isp_tts_tpu/models/vocoder/model.py``: an embedding conv,
a ConvNeXt-1D backbone (depthwise conv k=7, LayerNorm, pointwise 4x-style
expansion, GELU, projection, layer-scale residual), and an iSTFT head
(Linear(dim -> n_fft + 2): log-magnitude and phase per frame) through the
matmul inverse STFT of :mod:`isp_tts_tpu_torch.ops.vocoder`. Channel-last
(B, T, C) as in the JAX package; one mel frame gives ``hop_length`` samples.

The ``discriminator`` config (GAN training) is kept but not built.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import as_dict, build_config
from ...ops.vocoder import istft_matmul, log_mel_matmul
from ..base import Model


class VocoderOutput(NamedTuple):
    audio_fake: torch.Tensor  # (B, S) generated waveform
    mel: torch.Tensor  # (B, T, n_mels) log-mel of the real audio


@dataclass
class MelFeatureConfig:
    """The STFT/mel contract; it must match the acoustic model's."""
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = 8000.0


@dataclass
class VocosGeneratorConfig:
    n_mels: int = 80
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    #: layer-scale init; None = 1 / num_layers
    layer_scale_init: float | None = None
    #: log-magnitude clip before exp
    max_log_mag: float = 4.6
    #: lower log-magnitude clip; None = none
    min_log_mag: float | None = -4.6
    #: "tanh" or "exact" (erf) GELU
    gelu: str = "tanh"


class LayerNorm(nn.Module):
    """flax's LayerNorm: var = E[x^2] - E[x]^2 (``use_fast_variance``), and
    the scale folded into the inverse deviation before it multiplies."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A "SAME" Conv1d on channel-last (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale: float,
                 gelu_approximate: bool = True):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale)))
        self.approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(_conv(self.dwconv, x))
        h = self.pwconv2(F.gelu(self.pwconv1(h), approximate=self.approximate))
        return x + self.gamma * h


class VocosGenerator(nn.Module):
    def __init__(self, config: VocosGeneratorConfig):
        super().__init__()
        cfg = self.config = config
        scale = cfg.layer_scale_init if cfg.layer_scale_init is not None else 1.0 / cfg.num_layers
        self.embed = nn.Conv1d(cfg.n_mels, cfg.dim, 7, padding=3)
        self.norm_pre = LayerNorm(cfg.dim)
        self.blocks = nn.ModuleList([
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, scale,
                          gelu_approximate=(cfg.gelu != "exact"))
            for _ in range(cfg.num_layers)])
        self.norm_post = LayerNorm(cfg.dim)
        self.head = nn.Linear(cfg.dim, cfg.n_fft + 2)

    def spectrum(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) log-mel -> (B, T, n_fft + 2) f32 head output:
        log-magnitudes then phases of each frame's spectrum."""
        x = self.norm_pre(_conv(self.embed, mel))
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm_post(x).float())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) log-mel -> (B, T * hop_length) waveform."""
        cfg = self.config
        h = self.spectrum(mel)
        n_freqs = cfg.n_fft // 2 + 1
        log_mag = torch.clamp(h[..., :n_freqs], max=cfg.max_log_mag)
        if cfg.min_log_mag is not None:
            log_mag = torch.clamp(log_mag, min=cfg.min_log_mag)
        phase = h[..., n_freqs:]
        mag = torch.exp(log_mag)
        spec_re = (mag * torch.cos(phase)).transpose(-1, -2)  # (B, F, T)
        spec_im = (mag * torch.sin(phase)).transpose(-1, -2)
        audio, _ = istft_matmul(spec_re, spec_im, cfg.n_fft, cfg.hop_length, cfg.n_fft)
        # crop the analysis centring pad: T frames <-> T * hop samples
        pad = (cfg.n_fft - cfg.hop_length) // 2
        return audio[..., pad:audio.shape[-1] - pad]


@dataclass
class VocoderModelConfig:
    generator: VocosGeneratorConfig = field(default_factory=VocosGeneratorConfig)
    #: the GAN discriminators' config, kept for the checkpoint; not built
    discriminator: dict = field(default_factory=dict)
    features: MelFeatureConfig = field(default_factory=MelFeatureConfig)


class VocoderModel(Model):
    """The generator of the JAX package's ``VocoderModel`` (inference and the
    generator's training forward); its discriminators are not ported yet."""

    Config = VocoderModelConfig

    def __init__(self, config: VocoderModelConfig):
        super().__init__()
        self.config = config
        self.features_config = build_config(MelFeatureConfig, as_dict(config.features))
        f = self.features_config
        self.generator = VocosGenerator(build_config(
            VocosGeneratorConfig, as_dict(config.generator), n_mels=f.n_mels,
            n_fft=f.n_fft, hop_length=f.hop_length))

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, S) waveform -> (B, S / hop, n_mels) log-mel (matmul DFT)."""
        f = self.features_config
        return log_mel_matmul(audio, f.sample_rate, f.n_fft, f.hop_length, f.win_length,
                              f.n_mels, f.f_min, f.f_max)

    def forward(self, audio: torch.Tensor, mel: torch.Tensor | None = None) -> VocoderOutput:
        """``mel`` replaces the generator's input (predicted mels); the
        returned ``mel`` is always the real audio's, the target."""
        target = self.features(audio).detach()
        return VocoderOutput(audio_fake=self.generator(target if mel is None else mel),
                             mel=target)

    @torch.no_grad()
    def infer(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) log-mel -> (B, T * hop) waveform."""
        return self.generator(mel)

    def load_jax_state(self, flat: dict[str, np.ndarray]) -> None:
        """The generator's tensors, strictly; a GAN checkpoint's
        discriminator tensors are left out, as the discriminators are."""
        super().load_jax_state({k: v for k, v in flat.items()
                                if not k.startswith("discriminator.")})

    @classmethod
    def from_pretrained(cls, path: str | Path, device: str | torch.device | None = None):
        """A ``.ckpt`` vocoder on ``device`` (CUDA unless named)."""
        if Path(path).suffix in (".pt", ".pts", ".pth", ".bin"):
            raise NotImplementedError(
                f"{path}: torch Vocos checkpoints are read by the reference-interop "
                "item (ROADMAP Queue 1 item 7), not ported yet; pass a .ckpt")
        return super().from_pretrained(path, device=device)
