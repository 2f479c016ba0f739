"""Position-wise feed-forward block (counterpart of ``isp_tts_tpu/nn/feedforward.py``).

Inference only: a config's dropout is ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .layers import choose_activation


@dataclass
class FeedForwardConfig:
    dim: int = 384
    inner_dim: int = 1536
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            h = h * self.act(gate)
        else:
            h = self.act(h)
        return self.fc2(h)
