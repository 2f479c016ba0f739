"""Multi-query self-attention with learned ALiBi.

Counterpart of ``isp_tts_tpu/nn/attention.py:Attention`` for the layers the
shipped recipes build: one key/value head (``one_kv_head``), self-attention
with a padding mask. Cross-attention, explicit attention masks, KV caches
and ring attention are not ported yet; multi-KV-head layers need the
per-head-grid kernels (K5a/K5b), which are not ported either, so they are
refused.

``flash`` picks the core: "off" runs
:func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_attention_reference`,
the plain einsum version, differentiated by autograd; any other value
("auto", "on", and "ring", which the JAX package runs locally on one
device) runs :func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_attention`
— kernels K1 (forward) and K2 (backward) on CUDA tensors, their plain
versions on CPU tensors. In train mode a nonzero ``dropout`` drops
attention probabilities on both cores with the same hashed keep mask, from
a seed drawn per call from the layer's dropout generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.flash_attention import drop_params, mqa_attention, mqa_attention_reference
from .embeddings import LearnedALiBiBias
from .layers import FastDropout


@dataclass
class AttentionConfig:
    dim: int = 256
    heads: int = 4
    head_dim: int | None = 64
    causal: bool = False
    dropout: float = 0.0
    one_kv_head: bool = False
    alibi_pos_bias: bool = False
    alibi_heads: int | None = None
    alibi_symmetric: bool = True
    flash: str = "auto"


class Attention(nn.Module):
    def __init__(self, config: AttentionConfig):
        super().__init__()
        cfg = config
        if not cfg.one_kv_head:
            raise NotImplementedError(
                "multi-KV-head attention needs the per-head-grid kernel (K5a), "
                "which is not ported yet")
        self.heads = cfg.heads
        self.head_dim = cfg.head_dim or cfg.dim // cfg.heads
        self.causal = cfg.causal
        self.scale = self.head_dim ** -0.5
        self.flash = cfg.flash
        q_dim = self.head_dim * self.heads
        self.to_q = nn.Linear(cfg.dim, q_dim, bias=False)
        self.to_kv = nn.Linear(cfg.dim, 2 * self.head_dim, bias=False)
        self.to_out = nn.Linear(q_dim, cfg.dim, bias=False)
        self.dropout = FastDropout(cfg.dropout)
        alibi_heads = cfg.alibi_heads if cfg.alibi_heads is not None else cfg.heads
        if alibi_heads > cfg.heads:
            raise ValueError("alibi_heads must be <= heads")
        self.rel_pos = (LearnedALiBiBias(alibi_heads, cfg.heads, cfg.alibi_symmetric)
                        if cfg.alibi_pos_bias else None)

    def _slopes2(self, device) -> torch.Tensor:
        """(2, heads) [lower, upper] slopes; zeros without a relative bias."""
        if self.rel_pos is None:
            return torch.zeros((2, self.heads), device=device)
        return self.rel_pos.slopes2()

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, N, dim); mask (B, N) bool, True = valid. Returns (B, N, dim)."""
        b, n, _ = x.shape
        q = self.to_q(x).reshape(b, n, self.heads, self.head_dim)
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, N, D) each
        rate = self.dropout.rate if self.training and drop_params(self.dropout.rate) else 0.0
        seed = self.dropout.draw_seed(x.device) if rate else None
        lens = (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                else torch.full((b,), n, dtype=torch.int32, device=x.device))
        args = (q.contiguous(), k.contiguous(), v.contiguous(), self._slopes2(x.device),
                lens, self.scale, 0)
        kwargs = dict(q_lens=lens, causal=self.causal, dropout_rate=rate, seed=seed)
        if self.flash == "off":
            out, _ = mqa_attention_reference(*args, **kwargs)
        else:
            out = mqa_attention(*args, **kwargs)
        out = self.to_out(out.reshape(b, n, self.heads * self.head_dim))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out
