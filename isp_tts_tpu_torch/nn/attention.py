"""Multi-query self-attention with learned ALiBi.

Counterpart of ``isp_tts_tpu/nn/attention.py:Attention`` for the layers the
shipped recipes build: one key/value head (``one_kv_head``), self-attention
with a padding mask. Cross-attention, explicit attention masks, KV caches,
ring attention and dropout are not part of the serving path and are not
ported yet; multi-KV-head layers need the per-head-grid kernel (K5a), which
is not ported either, so they are refused.

``flash`` picks the core: "off" runs the einsum SDPA with this layer's ALiBi
bias materialised; any other value ("auto", "on", and "ring", which the JAX
package runs locally on one device) runs
:func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_fwd` — kernel K1 on a
CUDA tensor, its plain version on a CPU tensor. A config's dropout and
cross-attention settings are ignored: serving does not use them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from ..ops.flash_attention import mqa_fwd
from .embeddings import LearnedALiBiBias, alibi_distance_bias


@dataclass
class AttentionConfig:
    dim: int = 256
    heads: int = 4
    head_dim: int | None = 64
    causal: bool = False
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                shared_bias: torch.Tensor | None = None):
        """x (B, N, dim); mask (B, N) bool, True = valid.

        Returns (out (B, N, dim), shared_bias): the slope-free distance
        matrix, computed once per stack on the einsum path.
        """
        b, n, _ = x.shape
        q = self.to_q(x).reshape(b, n, self.heads, self.head_dim)
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, N, D) each
        if self.flash == "off":
            bias = None
            if self.rel_pos is not None:
                if shared_bias is None:
                    shared_bias = alibi_distance_bias(n, n, 0, device=x.device)
                bias = self.rel_pos.apply_slopes(shared_bias, offset=0)
            attn_mask = mask[:, None, None, :] if mask is not None else None
            out = scaled_dot_product_attention(
                q.transpose(1, 2), k[:, None], v[:, None], scale=self.scale,
                bias=bias, mask=attn_mask, causal=self.causal).transpose(1, 2)
        else:
            lens = (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                    else torch.full((b,), n, dtype=torch.int32, device=x.device))
            out, _ = mqa_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                             self._slopes2(x.device), lens, self.scale, 0,
                             q_lens=lens, causal=self.causal)
        out = self.to_out(out.reshape(b, n, self.heads * self.head_dim))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out, shared_bias
