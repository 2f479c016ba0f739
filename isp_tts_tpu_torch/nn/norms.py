"""LayerNorm and AdaLN (counterpart of ``isp_tts_tpu/nn/norms.py``).

Both take statistics in f32 and accept a ``condition`` argument, so plain
and adaptive norms are interchangeable inside a transformer layer.
"""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm that ignores ``condition``; ``norm.weight`` is flax's scale."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor, condition: torch.Tensor | None = None):
        return self.norm(x.float()).to(x.dtype)


class AdaptiveLayerNorm(nn.Module):
    """AdaLN: scale and shift are linear maps of a condition vector."""

    def __init__(self, dim: int, condition_dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Linear(condition_dim, dim)
        self.bias = nn.Linear(condition_dim, dim)

    def forward(self, x: torch.Tensor, condition: torch.Tensor | None = None):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        normed = (xf - mean) / torch.sqrt(var + self.eps)
        if condition is not None:
            if condition.dim() == x.dim() - 1:
                condition = condition[:, None, :]
            normed = self.weight(condition) * normed + self.bias(condition)
        return normed.to(x.dtype)
