"""Position-wise feed-forward block (counterpart of ``isp_tts_tpu/nn/feedforward.py``):
Linear -> activation (or GLU) -> dropout (train mode) -> Linear.

Split over the model axis (``tp``, set by
:func:`~isp_tts_tpu_torch.parallel.mesh.shard_params`), each rank holds
its share of the inner dim: ``fc1``'s rows (both GLU halves alike) and
``fc2``'s columns; ``fc2``'s partial products are summed over the model
group before its bias."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import copy_to, reduce_from
from .layers import FastDropout, choose_activation


@dataclass
class FeedForwardConfig:
    dim: int = 384
    inner_dim: int = 1536
    dropout: float = 0.0
    activation: str = "relu"
    bias: bool = False
    glu: bool = False


class FeedForward(nn.Module):
    def __init__(self, config: FeedForwardConfig):
        super().__init__()
        cfg = config
        self.act = choose_activation(cfg.activation)
        self.glu = cfg.glu
        self.fc1 = nn.Linear(cfg.dim, cfg.inner_dim * (2 if cfg.glu else 1),
                             bias=cfg.bias)
        self.fc2 = nn.Linear(cfg.inner_dim, cfg.dim, bias=cfg.bias)
        self.dropout = FastDropout(cfg.dropout)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to(x, self.tp.group)
        h = self.fc1(x)
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            h = h * self.act(gate)
        else:
            h = self.act(h)
        h = self.dropout(h)
        if self.tp is None:
            return self.fc2(h)
        out = reduce_from(F.linear(h, self.fc2.weight), self.tp.group)
        return out if self.fc2.bias is None else out + self.fc2.bias
