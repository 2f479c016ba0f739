"""Self-attention with learned ALiBi, one or H key/value heads.

Counterpart of ``isp_tts_tpu/nn/attention.py:Attention`` for the layers the
acoustic model builds: self-attention with a padding mask, either with one
key/value head (``one_kv_head``, multi-query) or with one per query head
(the default). Cross-attention (``context_dim``), explicit attention
masks and KV caches are not ported yet; a config that sets
``context_dim`` raises, and so does a head dim other than the kernels' 64
unless ``flash`` is "off".

The core follows the JAX dispatch: a one-KV-head layer runs the folded-MQA
family, a multi-KV-head layer the per-head family. ``flash`` picks the
version: "off" runs the family's plain einsum version
(:func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_attention_reference` or
:func:`~isp_tts_tpu_torch.ops.flash_attention.flash_attention_reference`),
differentiated by autograd; "ring" runs ring attention
(:func:`~isp_tts_tpu_torch.ops.ring_attention.ring_attention`, the port of
``_maybe_ring``) whenever the live parallel context names a seq axis, even
one of size 1: q, k and v are computed on the replicated activations, each
seq rank keeps its rows (``split_seq``), the ring runs over the seq group,
and the output is gathered (``gather_seq``) before ``to_out``. With no seq
axis, or for a sequence that does not divide over it (one warning a
layer), "ring" runs as "auto". Any other value ("auto", "on") runs the
family's registered operator (``isp_tts::mqa_fwd`` or ``isp_tts::flash_fwd``, one
node of an exported program) — kernels K1/K2 or K5a/K5b on CUDA tensors,
their plain versions on CPU tensors. Under fp16 autocast the kernels run on the fp16
values widened to f32 (exactly), their output narrowed back. In train mode a nonzero ``dropout`` drops
attention probabilities on both versions with the same hashed keep mask,
from a seed drawn per call from the layer's dropout generator.

Under a data split the hash is placed at this rank's first batch row (the
live parallel context's data rank times the local batch, or the row
window a stacked layer stack sets: ``parallel.context.batch_origin``). Split over the
model axis (``tp``, set by
:func:`~isp_tts_tpu_torch.parallel.mesh.shard_params`), a rank holds
``to_q``'s rows and ``to_out``'s columns of its H/tp heads, runs the
kernel on those heads (placed at its first head of the H in the hash, so
its masks are one rank's), and sums ``to_out``'s partial products over
the model group. ``to_kv`` and the slopes stay whole: a rank slices its
heads' share (with one KV head, all of it), and their gradients, partial
on each rank, are summed over the model group by the trainer.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from ..ops.flash_attention import (HEAD_DIM, drop_params, flash_attention,
                                   flash_attention_reference, mqa_attention,
                                   mqa_attention_reference)
from ..ops.ring_attention import ring_attention
from ..parallel.context import batch_origin, get_parallel_context
from ..parallel.mesh import copy_to, gather_seq, reduce_from, split_seq
from .embeddings import LearnedALiBiBias
from .layers import FastDropout

logger = logging.getLogger("isp_tts_tpu_torch")


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
    #: auto | on | off | ring: "ring" rings over the live seq axis and runs
    #: as "auto" without one
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
        self.tp = None
        self._ring_warned = False

    def _ring_group(self, n: int):
        """(True, the seq group) when this call rings; (False, None) when it
        runs the local kernels (no seq axis, or ``n`` not divisible by it)."""
        ctx = get_parallel_context()
        if self.flash != "ring" or ctx.seq_axis is None:
            return False, None
        if n % ctx.seq_size:
            if not self._ring_warned:
                logger.warning("flash='ring': sequence %d does not divide over the seq axis "
                               "of %d; this layer runs the local kernels", n, ctx.seq_size)
                self._ring_warned = True
            return False, None
        return True, ctx.axis_group("seq")

    def _slopes2(self, device) -> torch.Tensor:
        """(2, heads) [lower, upper] slopes; zeros without a relative bias."""
        if self.rel_pos is None:
            return torch.zeros((2, self.heads), device=device)
        return self.rel_pos.slopes2()

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, N, dim); mask (B, N) bool, True = valid. Returns (B, N, dim)."""
        b, n, _ = x.shape
        heads, head0, slopes = self.heads, 0, self._slopes2(x.device)
        if self.tp is not None:
            heads //= self.tp.size
            head0 = self.tp.rank * heads
            slopes = slopes[:, head0:head0 + heads]
            x = copy_to(x, self.tp.group)
        q = self.to_q(x).reshape(b, n, heads, self.head_dim)
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, N, Hkv * D) each, K first
        if self.one_kv_head:
            core, plain = mqa_attention, mqa_attention_reference
        else:
            core, plain = flash_attention, flash_attention_reference
            k = k.reshape(b, n, self.heads, self.head_dim)[:, :, head0:head0 + heads]
            v = v.reshape(b, n, self.heads, self.head_dim)[:, :, head0:head0 + heads]
        rate = self.dropout.rate if self.training and drop_params(self.dropout.rate) else 0.0
        seed = self.dropout.draw_seed(x.device) if rate else None
        lens = (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                else torch.full((b,), n, dtype=torch.int32, device=x.device))
        kwargs = dict(q_lens=lens, causal=self.causal, dropout_rate=rate, seed=seed,
                      batch0=batch_origin(b), head0=head0, heads_total=self.heads)
        ring, group = self._ring_group(n)
        if ring:
            if self.one_kv_head:
                k, v = k[:, :, None], v[:, :, None]
            q, k, v = (split_seq(t, group, dim=1) for t in (q, k, v))
            out = gather_seq(ring_attention(q, k, v, slopes, lens, self.scale, group=group,
                                            **kwargs), group, dim=1)
            return self._project(out, b, n, heads, mask)
        half = q.dtype == torch.float16 and q.device.type == "cuda" and self.flash != "off"
        if half:  # the kernels take f32 and bf16: fp16 values are exact in f32
            q, k, v = q.float(), k.float(), v.float()
        args = (q.contiguous(), k.contiguous(), v.contiguous(), slopes.contiguous(),
                lens, self.scale, 0)
        if self.flash == "off":
            out, _ = plain(*args, **kwargs)
        else:
            out = core(*args, **kwargs)
        if half:
            out = out.half()
        return self._project(out, b, n, heads, mask)

    def _project(self, out, b, n, heads, mask):
        """``to_out`` of the core's (B, N, heads, D) output, masked."""
        out = out.reshape(b, n, heads * self.head_dim)
        out = (self.to_out(out) if self.tp is None
               else reduce_from(self.to_out(out), self.tp.group))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out
