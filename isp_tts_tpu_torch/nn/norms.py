"""Normalization layers (counterpart of ``isp_tts_tpu/nn/norms.py``).

LayerNorm and AdaLN take statistics in f32 and accept a ``condition``
argument, so plain and adaptive norms are interchangeable inside a
transformer layer. The masked instance and batch norms take (B, T, C)
sequences and a (B, T) mask, so padded positions never reach their
statistics; :func:`~isp_tts_tpu_torch.nn.layers.choose_normalization`
picks one by name.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.context import get_parallel_context
from ..parallel.mesh import copy_to, data_sum, reduce_from


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
            # f32 maps of the condition, as the JAX package's AdaLN linears
            # (built without a compute dtype) under a bf16 policy
            with torch.autocast(x.device.type, enabled=False):
                c = condition.float()
                normed = self.weight(c) * normed + self.bias(c)
        return normed.to(x.dtype)


class MaskedInstanceNorm1d(nn.Module):
    """Instance norm over time using valid positions only (biased variance),
    affine; (B, T, C) in, statistics in f32. ``weight`` is flax's scale."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m = mask[:, :, None].float()
        count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (xf * m).sum(dim=1, keepdim=True) / count
        var = ((xf - mean) ** 2 * m).sum(dim=1, keepdim=True) / count
        return ((xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias) * m


def _data_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, forward and backward (each data
    rank's loss reads the global sum): the identity with one data rank."""
    ctx = get_parallel_context()
    if ctx.data_size == 1:
        return x
    group = ctx.group("data")
    return reduce_from(copy_to(x, group), group)


class MaskedBatchNorm1d(nn.Module):
    """Batch norm over (batch, time) using only unmasked positions, with
    running statistics updated from the masked ones.

    (B, T, C) in, (B, T) mask (True = valid). In train mode the statistics
    are the masked mean and biased variance over every valid position of
    the batch, and the buffers ``mean``/``var`` move toward them with
    ``momentum`` (JAX's ``nnx.BatchStat``, updated on every train-mode call
    as the JAX trainer's steps update it, micro-steps and chunked steps
    alike); in eval mode the buffers are read. Affine ``weight`` (flax's
    ``scale``) and ``bias``. Statistics in f32; padded positions give 0.

    Under a data split the JAX package's sums run over the sharded global
    batch: here the masked sums and the count are summed over the data
    group before dividing (the sums' gradients summed back), so every rank
    normalises with, and stores, the statistics of the global batch.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        xf = x.float()
        m = (mask[:, :, None].float() if mask is not None
             else torch.ones_like(xf[..., :1]))
        if self.training:
            count = data_sum(m.sum()).clamp_min(1.0)
            mean = _data_total((xf * m).sum(dim=(0, 1))) / count
            var = _data_total(((xf - mean) ** 2 * m).sum(dim=(0, 1))) / count
            with torch.no_grad():
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * var)
        else:
            mean, var = self.mean, self.var
        out = (xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return out * m if mask is not None else out
