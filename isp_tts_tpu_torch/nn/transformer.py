"""Transformer layer and stack (counterpart of ``isp_tts_tpu/nn/transformer.py``).

The per-layer path only: the stacked pipeline-parallel layout waits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from ..config import as_dict, build_config
from .attention import Attention, AttentionConfig
from .embeddings import fixed_positional_embedding
from .feedforward import FeedForward, FeedForwardConfig
from .norms import AdaptiveLayerNorm, LayerNorm


@dataclass
class TransformerLayerConfig:
    dim: int = 384
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    feed_forward: FeedForwardConfig = field(default_factory=FeedForwardConfig)
    pre_norm: bool = True
    adaptive_norm: bool = False
    condition_dim: int | None = None


class TransformerLayer(nn.Module):
    def __init__(self, config: TransformerLayerConfig):
        super().__init__()
        cfg = config
        self.pre_norm = cfg.pre_norm
        self.adaptive_norm = cfg.adaptive_norm
        if cfg.adaptive_norm and cfg.condition_dim is None:
            raise ValueError("adaptive_norm requires condition_dim")

        def make_norm():
            if cfg.adaptive_norm:
                return AdaptiveLayerNorm(cfg.dim, cfg.condition_dim)
            return LayerNorm(cfg.dim)

        self.attention_norm = make_norm()
        self.attention = Attention(
            build_config(AttentionConfig, as_dict(cfg.attention), dim=cfg.dim))
        self.feed_forward_norm = make_norm()
        self.feed_forward = FeedForward(
            build_config(FeedForwardConfig, as_dict(cfg.feed_forward), dim=cfg.dim))

    def forward(self, x, mask=None, adaptive_condition=None):
        if self.adaptive_norm and adaptive_condition is None:
            raise ValueError("adaptive_condition must be provided for AdaptiveLayerNorm")
        fmask = mask[..., None].to(x.dtype) if mask is not None else None
        residual = x
        out = self.attention_norm(x, adaptive_condition) if self.pre_norm else x
        out = self.attention(out, mask=mask)
        out = out + residual
        if not self.pre_norm:
            out = self.attention_norm(out, adaptive_condition)
        residual = out
        if self.pre_norm:
            out = self.feed_forward_norm(out, adaptive_condition)
        if fmask is not None:
            out = out * fmask
        out = self.feed_forward(out) + residual
        if not self.pre_norm:
            out = self.feed_forward_norm(out, adaptive_condition)
        if fmask is not None:
            out = out * fmask
        return out


@dataclass
class TransformerConfig:
    dim: int = 384
    depth: int = 6
    transformer_layer: TransformerLayerConfig = field(default_factory=TransformerLayerConfig)
    emb_dim: int | None = None
    use_abs_pos_emb: bool = True
    adaptive_norm: bool = False
    condition_dim: int | None = None
    pipeline: bool = False


class Transformer(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = config
        if cfg.pipeline:
            raise NotImplementedError("the stacked (pipeline) layer layout is not ported yet")
        self.emb_dim = cfg.emb_dim or cfg.dim
        layer_cfg = build_config(
            TransformerLayerConfig, as_dict(cfg.transformer_layer), dim=cfg.dim,
            adaptive_norm=cfg.adaptive_norm, condition_dim=cfg.condition_dim)
        self.layers = nn.ModuleList(TransformerLayer(layer_cfg) for _ in range(cfg.depth))
        has_rel_pos = self.layers[0].attention.rel_pos is not None
        self.use_abs_pos_emb = cfg.use_abs_pos_emb and not has_rel_pos
        self.project_emb = (nn.Linear(self.emb_dim, cfg.dim)
                            if self.emb_dim != cfg.dim else None)
        # flax's nnx.LayerNorm default epsilon
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6) if layer_cfg.pre_norm else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                adaptive_condition: torch.Tensor | None = None) -> torch.Tensor:
        if self.use_abs_pos_emb:
            x = x + fixed_positional_embedding(x.shape[1], self.emb_dim,
                                               device=x.device, dtype=x.dtype)
        if self.project_emb is not None:
            x = self.project_emb(x)
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            # the residual stream runs in the compute dtype, as the JAX
            # package's ``stream_dtype``: its adds are bf16 under bf16 autocast
            # (the norms still take their statistics in f32)
            x = x.to(torch.get_autocast_dtype(dev))
        for layer in self.layers:
            x = layer(x, mask=mask, adaptive_condition=adaptive_condition)
        if self.norm is not None:
            x = self.norm(x.float())
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x
