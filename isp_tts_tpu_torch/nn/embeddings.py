"""Positional embeddings: sinusoids, learned ALiBi, flow-time embedding.

Counterpart of ``isp_tts_tpu/nn/embeddings.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import choose_activation


def alibi_slopes(heads: int) -> list[float]:
    """ALiBi head slopes, including non-power-of-two head counts."""

    def pow2_slopes(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(heads).is_integer():
        return pow2_slopes(heads)
    closest = 2 ** math.floor(math.log2(heads))
    return pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: heads - closest]


def fixed_positional_embedding(seq_len: int, dim: int, device=None,
                               dtype=torch.float32) -> torch.Tensor:
    """(seq_len, dim) sinusoid table: [sin | cos] halves, odd dims trimmed."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device,
                                               dtype=torch.float32) / dim))
    pos = torch.arange(seq_len, device=device, dtype=torch.float32)
    angles = pos[:, None] * inv_freq[None, :]
    emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return emb[:, :dim].to(dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                         freq_scale: float = 1.0) -> torch.Tensor:
    """Continuous-position sinusoid: (...,) -> (..., dim), [sin | cos] halves."""
    half = dim // 2
    inv_freq = theta ** -(torch.arange(half, device=positions.device,
                                       dtype=torch.float32) / half)
    angles = positions.float()[..., None] * freq_scale * inv_freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def alibi_distance_bias(n_q: int, n_k: int, offset: int = 0,
                        device=None) -> torch.Tensor:
    """(n_q, n_k) matrix of -|j - (i + offset)|."""
    i = torch.arange(offset, n_q + offset, device=device)
    j = torch.arange(n_k, device=device)
    return -(j[None, :] - i[:, None]).abs().float()


class LearnedALiBiBias(nn.Module):
    """ALiBi with trainable per-head log-slopes; ``symmetric=False`` keeps
    separate lower- and upper-triangle slopes. The parameter's shape is the
    JAX package's: (heads, 1, 1), or (2, heads, 1, 1)."""

    def __init__(self, heads: int, total_heads: int, symmetric: bool = True):
        super().__init__()
        self.heads = heads
        self.total_heads = total_heads
        self.symmetric = symmetric
        slopes = torch.tensor(alibi_slopes(heads), dtype=torch.float32)[:, None, None]
        if not symmetric:
            slopes = torch.stack([slopes, torch.roll(slopes, -1, dims=0)])
        self.log_slopes = nn.Parameter(torch.log(slopes))

    def apply_slopes(self, dist: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """This layer's slopes on a (n_q, n_k) distance matrix ->
        (total_heads, n_q, n_k) bias; heads past ``heads`` get none."""
        n_q, n_k = dist.shape
        slopes = torch.exp(self.log_slopes.float())
        if self.symmetric:
            bias = slopes * dist[None]
        else:
            i = torch.arange(n_q, device=dist.device)[:, None]
            j = torch.arange(n_k, device=dist.device)[None, :]
            lower = j <= i + offset
            bias = torch.where(lower[None], slopes[0] * dist[None],
                               slopes[1] * dist[None])
        if self.total_heads > self.heads:
            pad = bias.new_zeros((self.total_heads - self.heads, n_q, n_k))
            bias = torch.cat([bias, pad], dim=0)
        return bias

    def slopes2(self) -> torch.Tensor:
        """(2, total_heads) [lower, upper] slopes for the kernel path."""
        slopes = torch.exp(self.log_slopes.float())
        pad = self.total_heads - self.heads
        if self.symmetric:
            s = nn.functional.pad(slopes[:, 0, 0], (0, pad))
            return torch.stack([s, s])
        lo = nn.functional.pad(slopes[0, :, 0, 0], (0, pad))
        hi = nn.functional.pad(slopes[1, :, 0, 0], (0, pad))
        return torch.stack([lo, hi])


class TimePositionalEmbedding(nn.Module):
    """Flow-matching time embedding: sinusoid(t * freq_scale) -> MLP(SiLU);
    ``with_steps`` prepends the raw time to the sinusoid features."""

    def __init__(self, freq_dim: int = 256, emb_dim: int = 512, theta: float = 1000.0,
                 freq_scale: float = 1000.0, with_steps: bool = True):
        super().__init__()
        self.freq_dim = freq_dim
        self.theta = theta
        self.freq_scale = freq_scale
        self.with_steps = with_steps
        self.fc1 = nn.Linear(freq_dim + int(with_steps), emb_dim)
        self.fc2 = nn.Linear(emb_dim, emb_dim)
        self.act = choose_activation("silu")

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_embedding(t, self.freq_dim, self.theta, self.freq_scale)
        if self.with_steps:
            emb = torch.cat([t.float()[..., None], emb], dim=-1)
        return self.fc2(self.act(self.fc1(emb)))
