"""Self-attention with learned ALiBi, one or H key/value heads.

Counterpart of ``isp_tts_tpu/nn/attention.py:Attention`` for the layers the
acoustic model builds: self-attention with a padding mask, either with one
key/value head (``one_kv_head``, multi-query) or with one per query head
(the default). Cross-attention (``context_dim``), explicit attention
masks, KV caches and ring attention are not ported yet; a config that sets
``context_dim`` raises, and so does a head dim other than the kernels' 64
unless ``flash`` is "off".

The core follows the JAX dispatch: a one-KV-head layer runs the folded-MQA
family, a multi-KV-head layer the per-head family. ``flash`` picks the
version: "off" runs the family's plain einsum version
(:func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_attention_reference` or
:func:`~isp_tts_tpu_torch.ops.flash_attention.flash_attention_reference`),
differentiated by autograd; any other value ("auto", "on", and "ring",
which the JAX package runs locally on one device) runs the family's
autograd function — kernels K1/K2 or K5a/K5b on CUDA tensors, their plain
versions on CPU tensors. Under fp16 autocast the kernels run on the fp16
values widened to f32 (exactly), their output narrowed back. In train mode a nonzero ``dropout`` drops
attention probabilities on both versions with the same hashed keep mask,
from a seed drawn per call from the layer's dropout generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.flash_attention import (HEAD_DIM, drop_params, flash_attention,
                                   flash_attention_reference, mqa_attention,
                                   mqa_attention_reference)
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
    #: cross-attention's context width; None (self-attention) is the only
    #: value the port computes
    context_dim: int | None = None
    alibi_pos_bias: bool = False
    alibi_heads: int | None = None
    alibi_symmetric: bool = True
    flash: str = "auto"

    def __post_init__(self):
        if self.context_dim is not None:
            raise NotImplementedError("cross-attention (context_dim) is not ported")
        head_dim = self.head_dim or self.dim // self.heads
        if self.flash != "off" and head_dim != HEAD_DIM:
            raise NotImplementedError(
                f"head_dim {head_dim}: the port's attention kernels take head dim "
                f"{HEAD_DIM}; set flash: off for the plain version")


class Attention(nn.Module):
    def __init__(self, config: AttentionConfig):
        super().__init__()
        cfg = config
        self.heads = cfg.heads
        self.head_dim = cfg.head_dim or cfg.dim // cfg.heads
        self.causal = cfg.causal
        self.scale = self.head_dim ** -0.5
        self.flash = cfg.flash
        self.one_kv_head = cfg.one_kv_head
        q_dim = self.head_dim * self.heads
        kv_dim = self.head_dim if cfg.one_kv_head else q_dim
        self.to_q = nn.Linear(cfg.dim, q_dim, bias=False)
        self.to_kv = nn.Linear(cfg.dim, 2 * kv_dim, bias=False)
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
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, N, Hkv * D) each, K first
        if self.one_kv_head:
            core, plain = mqa_attention, mqa_attention_reference
        else:
            core, plain = flash_attention, flash_attention_reference
            k = k.reshape(b, n, self.heads, self.head_dim)
            v = v.reshape(b, n, self.heads, self.head_dim)
        rate = self.dropout.rate if self.training and drop_params(self.dropout.rate) else 0.0
        seed = self.dropout.draw_seed(x.device) if rate else None
        lens = (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                else torch.full((b,), n, dtype=torch.int32, device=x.device))
        half = q.dtype == torch.float16 and q.device.type == "cuda" and self.flash != "off"
        if half:  # the kernels take f32 and bf16: fp16 values are exact in f32
            q, k, v = q.float(), k.float(), v.float()
        args = (q.contiguous(), k.contiguous(), v.contiguous(), self._slopes2(x.device),
                lens, self.scale, 0)
        kwargs = dict(q_lens=lens, causal=self.causal, dropout_rate=rate, seed=seed)
        if self.flash == "off":
            out, _ = plain(*args, **kwargs)
        else:
            out = core(*args, **kwargs)
        if half:
            out = out.half()
        out = self.to_out(out.reshape(b, n, self.heads * self.head_dim))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out
