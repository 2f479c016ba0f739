"""Positional embeddings: sinusoids, learned ALiBi, flow-time embedding;
and the token embedding whose gradient repeats itself bit for bit.

Counterpart of ``isp_tts_tpu/nn/embeddings.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.mesh import copy_to, reduce_from
from .layers import choose_activation


class _EmbeddingRows(torch.autograd.Function):
    """The rows of ``weight`` at ``ids``. The weight's gradient sums each
    row's gradients as a one-hot product in float64, which gives the same
    bits on every call: PyTorch's CUDA embedding backward adds repeated ids
    in a run-dependent order past 3072 ids (a batch of 32 x 192 tokens,
    most of them padding), so two runs of the same steps drifted apart."""

    @staticmethod
    def forward(ctx, ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = weight.shape[0], weight.dtype
        return nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        # a comparison, not F.one_hot, which reads the ids' range on the host
        one_hot = (flat[:, None] == torch.arange(ctx.rows, device=flat.device)).to(torch.float64)
        summed = one_hot.T @ grad.reshape(flat.numel(), -1).to(torch.float64)
        return None, summed.to(ctx.dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` (no padding index, norm limit or sparse gradient)
    whose weight gradient is the same bits on every call
    (:class:`_EmbeddingRows`); without a gradient, the plain lookup."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if (self.padding_idx is not None or self.max_norm is not None or self.sparse
                or self.scale_grad_by_freq):
            raise ValueError("Embedding takes no padding_idx, max_norm, sparse or "
                             "scale_grad_by_freq")
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return _EmbeddingRows.apply(ids, self.weight)
        return nn.functional.embedding(ids, self.weight)


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

    def slopes2(self) -> torch.Tensor:
        """(2, total_heads) [lower, upper] slopes for the kernel path: f32,
        or f64 in a float64 module (the plain path's exact reference)."""
        log_slopes = self.log_slopes
        slopes = torch.exp(log_slopes if log_slopes.dtype == torch.float64
                           else log_slopes.float())
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
        #: the model-axis split of fc1's rows and fc2's columns (the JAX TP
        #: rules match its fc1/fc2 too), set by shard_params
        self.tp = None

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_embedding(t, self.freq_dim, self.theta, self.freq_scale)
        if self.with_steps:
            emb = torch.cat([t.float()[..., None], emb], dim=-1)
        if self.tp is None:
            return self.fc2(self.act(self.fc1(emb)))
        h = self.act(self.fc1(copy_to(emb, self.tp.group)))
        return reduce_from(nn.functional.linear(h, self.fc2.weight), self.tp.group) + \
            self.fc2.bias
