"""Flow-matching temporal adaptor, inference path.

Counterpart of ``isp_tts_tpu/models/acoustic/adaptor.py``:
``FlowTransformerTemporalModule.infer`` (Euler ODE over the geometric time
grid), ``FlowTemporalAdaptor.infer`` (durations with the -1 sentinel, the
factor and delta controls, the pitch/energy feature embedding) and the hard
and soft length regulators. The flow noise is an argument, or is drawn from
a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch import nn

from ...config import as_dict, build_config
from ...nn.embeddings import TimePositionalEmbedding
from ...nn.transformer import Transformer, TransformerConfig
from ...utils.masks import get_float_mask_from_lengths, get_mask_3d


def length_regulate_hard(x: torch.Tensor, durations: torch.Tensor, max_len: int):
    """Repeat token states (B, T, C) by rounded durations (B, T) into
    (B, max_len, C); returns (out, dec_lens clipped at max_len)."""
    reps = torch.floor(durations.float() + 0.5)
    dec_lens = reps.sum(dim=1).to(torch.int32)
    csum = torch.cumsum(nn.functional.pad(reps, (1, 0)), dim=1)  # (B, T+1)
    r = torch.arange(max_len, device=x.device, dtype=torch.float32)[None, :, None]
    mult = ((csum[:, None, :-1] <= r) & (csum[:, None, 1:] > r)).to(x.dtype)
    out = torch.einsum("blt,btc->blc", mult, x)
    return out, dec_lens.clamp_max(max_len)


def length_regulate_soft(x: torch.Tensor, durations: torch.Tensor,
                         alignment: torch.Tensor, max_len: int | None = None):
    """Soft expansion with a fractional alignment (B, M, T): out = A @ x."""
    dec_lens = torch.floor(durations.sum(dim=1) + 0.5).to(torch.int32)
    out = torch.einsum("bmt,btc->bmc", alignment.to(x.dtype), x)
    if max_len is not None:
        out = out[:, :max_len]
        dec_lens = dec_lens.clamp_max(max_len)
    return out, dec_lens


def generate_soft_path(durations: torch.Tensor, mask3d: torch.Tensor) -> torch.Tensor:
    """(B, T, M) fractional path: row t covers its duration, split at the
    segment edges."""
    B, T, M = mask3d.shape
    cum = torch.cumsum(durations, dim=1).reshape(B * T)
    path = get_float_mask_from_lengths(cum, M).reshape(B, T, M)
    path = path - nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask3d


@dataclass
class TemporalModuleConfig:
    input_dim: int = 256
    output_dim: int = 256
    transformer: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(dim=128, depth=2))


class TransformerTemporalModule(nn.Module):
    """Transformer + linear head (the pitch/energy embedding network)."""

    def __init__(self, config: TemporalModuleConfig):
        super().__init__()
        cfg = config
        t_cfg = build_config(TransformerConfig, as_dict(cfg.transformer),
                             emb_dim=cfg.input_dim)
        self.transformer = Transformer(t_cfg)
        self.linear = nn.Linear(t_cfg.dim, cfg.output_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        out = self.linear(self.transformer(x, mask=mask))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


@dataclass
class FlowTemporalModuleConfig:
    input_dim: int = 256
    output_dim: int = 256
    transformer: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(dim=128, depth=2))
    time_embedding_dim: int | None = None


def time_grid(steps: int, step_factor: float = 0.75) -> torch.Tensor:
    """(steps + 1,) f32 ODE time grid from 0 to 1: geometric (large steps
    first) unless ``step_factor`` is 1."""
    if step_factor == 1.0:
        return torch.linspace(0.0, 1.0, steps + 1)
    pts = step_factor ** torch.arange(steps + 1, dtype=torch.float32)
    deltas = torch.cat([torch.zeros(1), -torch.diff(pts)])
    return torch.cumsum(deltas / deltas.sum(), dim=0)


class FlowTransformerTemporalModule(nn.Module):
    """Conditional flow matching over token-level feature vectors."""

    def __init__(self, config: FlowTemporalModuleConfig):
        super().__init__()
        cfg = config
        time_dim = cfg.time_embedding_dim or cfg.input_dim
        self.time_embedding = TimePositionalEmbedding(freq_dim=64, emb_dim=time_dim)
        t_cfg = build_config(TransformerConfig, as_dict(cfg.transformer),
                             emb_dim=cfg.output_dim + cfg.input_dim,
                             adaptive_norm=True, condition_dim=time_dim)
        self.transformer = Transformer(t_cfg)
        self.linear = nn.Linear(t_cfg.dim, cfg.output_dim)
        self.output_dim = cfg.output_dim

    def _velocity(self, x_t, cond, t_emb, mask):
        h = torch.cat([x_t, cond], dim=-1)
        return self.linear(self.transformer(h, mask=mask, adaptive_condition=t_emb))

    def infer(self, x: torch.Tensor, mask: torch.Tensor | None = None,
              steps: int = 4, step_factor: float = 0.75,
              noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Euler sampling from ``noise`` (B, T, output_dim), drawn from
        ``generator`` when not given."""
        B, T, _ = x.shape
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.bool, device=x.device)
        if noise is None:
            noise = torch.randn((B, T, self.output_dim), generator=generator,
                                device=x.device, dtype=x.dtype)
        x_t = noise.to(device=x.device, dtype=x.dtype)
        grid = time_grid(steps, step_factor).to(x.device)
        for i in range(steps):
            t_emb = self.time_embedding(grid[i].expand(B).to(x.dtype))
            v = self._velocity(x_t, x, t_emb, mask)
            x_t = x_t + (v * (grid[i + 1] - grid[i])).to(x_t.dtype)
        return x_t * mask[..., None].to(x_t.dtype)


class TemporalAdaptorOutput(NamedTuple):
    enc_out: torch.Tensor  # (B, max_dec_len, C)
    duration: torch.Tensor  # (B, T)
    dec_lengths: torch.Tensor  # (B,) int32
    pitch: torch.Tensor | None
    energy: torch.Tensor | None


@dataclass
class FlowTemporalAdaptorConfig:
    encoder_dim: int = 384
    predictor: FlowTemporalModuleConfig = field(default_factory=FlowTemporalModuleConfig)
    embedding: TemporalModuleConfig = field(default_factory=TemporalModuleConfig)
    pitch: bool = True
    energy: bool = True
    soft_duration: bool = False


class FlowTemporalAdaptor(nn.Module):
    def __init__(self, config: FlowTemporalAdaptorConfig):
        super().__init__()
        cfg = config
        self.use_pitch = cfg.pitch
        self.use_energy = cfg.energy
        self.feature_dim = 1 + int(cfg.pitch) + int(cfg.energy)
        self.pitch_idx = 1
        self.energy_idx = self.pitch_idx + (1 if cfg.pitch else 0)
        self.soft_duration = cfg.soft_duration
        self.predictor = FlowTransformerTemporalModule(
            build_config(FlowTemporalModuleConfig, as_dict(cfg.predictor),
                         input_dim=cfg.encoder_dim, output_dim=self.feature_dim))
        self.embedding = TransformerTemporalModule(
            build_config(TemporalModuleConfig, as_dict(cfg.embedding),
                         input_dim=self.feature_dim - 1, output_dim=cfg.encoder_dim))

    def infer(self, enc_out: torch.Tensor, enc_mask: torch.Tensor | None = None,
              max_dec_len: int = 2048, duration_target: torch.Tensor | None = None,
              duration_factor: float = 1.0, pitch_target: torch.Tensor | None = None,
              pitch_factor: float = 1.0, pitch_delta: float = 0.0,
              energy_target: torch.Tensor | None = None, energy_factor: float = 1.0,
              energy_delta: float = 0.0, steps: int = 4,
              noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> TemporalAdaptorOutput:
        """Sample features, apply the controls, expand to ``max_dec_len``
        frames. ``duration_target`` entries below 0 keep the prediction."""
        B, T, _ = enc_out.shape
        pred = self.predictor.infer(enc_out, mask=enc_mask, steps=steps,
                                    noise=noise, generator=generator)
        duration = duration_factor * (torch.exp(pred[..., 0]) - 1.0)
        if not self.soft_duration:
            duration = torch.round(duration)
        duration = duration.clamp_min(0.0)
        if duration_target is not None:
            dt = duration_target.to(duration.dtype)
            duration = torch.where(dt < 0, duration, dt)
        if enc_mask is not None:
            duration = duration * enc_mask.to(duration.dtype)

        feats = []
        pitch = energy = None
        if self.use_pitch:
            pitch = pred[..., self.pitch_idx] if pitch_target is None else pitch_target
            pitch = pitch * pitch_factor + pitch_delta
            feats.append(pitch[..., None])
        if self.use_energy:
            energy = pred[..., self.energy_idx] if energy_target is None else energy_target
            energy = energy * energy_factor + energy_delta
            feats.append(energy[..., None])
        if feats:
            enc_out = enc_out + self.embedding(torch.cat(feats, dim=-1), mask=enc_mask)

        if self.soft_duration:
            enc_lens = (enc_mask.sum(dim=1) if enc_mask is not None
                        else torch.full((B,), T, device=enc_out.device))
            dec_lens = torch.floor(duration.sum(dim=1) + 0.5).to(torch.int32)
            dec_lens = dec_lens.clamp_max(max_dec_len)
            mask3d = get_mask_3d(enc_lens, dec_lens, T, max_dec_len).float()
            alignment = generate_soft_path(duration, mask3d).transpose(1, 2)
            reg_out, dec_lens = length_regulate_soft(enc_out, duration, alignment,
                                                     max_len=max_dec_len)
        else:
            reg_out, dec_lens = length_regulate_hard(enc_out, duration, max_dec_len)
        return TemporalAdaptorOutput(enc_out=reg_out, duration=duration,
                                     dec_lengths=dec_lens, pitch=pitch, energy=energy)
