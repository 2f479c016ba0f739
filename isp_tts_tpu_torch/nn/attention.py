"""Attention with learned ALiBi, one or H key/value heads: self-attention,
cross-attention, explicit attention masks and KV caches.

Counterpart of ``isp_tts_tpu/nn/attention.py:Attention``, whose call it
follows line by line: ``forward(x, mask, context, context_mask,
attention_mask, cache, return_cache)``.

- ``context`` (B, M, context_dim) makes it cross-attention (``to_kv``
  reads ``context_dim``), with ``context_mask`` (B, M) as its key mask;
  otherwise the key mask is the padding ``mask`` (B, N).
- ``attention_mask`` (bool, (N, M), (H, N, M) or (B, H, N, M), True =
  attend) is ANDed into the key mask.
- ``cache`` is a (k, v) pair of (B, M, Hkv, D) tensors (the JAX package's
  (B, Hkv, M, D) with its head and key axes swapped, the kernels' layout):
  self-attention appends the new keys and values to it, cross-attention
  reuses it in place of ``to_kv(context)``. ``return_cache`` returns
  (out, (k, v)) with the keys and values this call attended to. A cache
  with a padding mask keeps the JAX einsum path's meaning, defined there at
  one query only (its (B, 1, 1, N) key mask broadcasts over the M keys):
  a valid query sees every cached key, a padded one none; more queries
  raise.

Dispatch (JAX's ``:165-181``): an ``attention_mask``, or ``context`` under
"auto", runs the plain masked path
(:func:`~isp_tts_tpu_torch.ops.flash_attention.masked_attention`, the
counterpart of ``isp_tts_tpu/ops/attention.py:scaled_dot_product_attention``
with each layer's own ALiBi at offset M - N), differentiated by autograd,
its dropout drawn from the layer's dropout generator; ``flash: on`` with
an ``attention_mask`` raises, as there. Every other call runs the
family's core at offset M - N, its key lengths from the key mask and its
query lengths from ``mask``: a one-KV-head layer the folded-MQA family, a
multi-KV-head layer the per-head family. "off" runs the family's plain
einsum version (:func:`~isp_tts_tpu_torch.ops.flash_attention.mqa_attention_reference`
or :func:`~isp_tts_tpu_torch.ops.flash_attention.flash_attention_reference`);
"auto" and "on" run the family's registered operator (``isp_tts::mqa_fwd``
or ``isp_tts::flash_fwd``, one node of an exported program) — kernels
K1/K2 or K5a/K5b on CUDA tensors, their plain versions on CPU tensors.
"ring" runs ring attention
(:func:`~isp_tts_tpu_torch.ops.ring_attention.ring_attention`, the port of
``_maybe_ring``) whenever the live parallel context names a seq axis, even
one of size 1: q, k and v are computed on the replicated activations, each
seq rank keeps its rows (``split_seq``), the ring runs over the seq group,
and the output is gathered (``gather_seq``) before ``to_out``. With no seq
axis, for a sequence that does not divide over it, or for a call the ring
does not take (context, an attention mask, a cache, N != M; one warning a
layer), "ring" runs as "auto". Under fp16 autocast the kernels run on the
fp16 values widened to f32 (exactly), their output narrowed back. In train
mode a nonzero ``dropout`` drops attention probabilities on both versions
of the core with the same hashed keep mask, from a seed drawn per call
from the layer's dropout generator.

Under a data split the hash is placed at this rank's first batch row (the
live parallel context's data rank times the local batch, or the row
window a stacked layer stack sets: ``parallel.context.batch_origin``). Split over the
model axis (``tp``, set by
:func:`~isp_tts_tpu_torch.parallel.mesh.shard_params`, in a stacked layer
stack too), a rank holds ``to_q``'s rows and ``to_out``'s columns of its
H/tp heads, runs the core on those heads (placed at its first head of the
H in the hash, so its masks are one rank's), and sums ``to_out``'s partial
products over the model group. ``to_kv`` and the slopes stay whole: a rank
slices its heads' share (with one KV head, all of it), and their
gradients, partial on each rank, are summed over the model group by the
trainer.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
from torch import nn

from ..ops.flash_attention import (HEAD_DIM_MAX, _geometry, drop_params, flash_attention,
                                   flash_attention_reference, masked_attention,
                                   mqa_attention, mqa_attention_reference)
from ..ops.ring_attention import ring_attention
from ..parallel.context import batch_origin, get_parallel_context
from ..parallel.mesh import copy_to, gather_seq, reduce_from, split_seq
from .embeddings import LearnedALiBiBias
from .layers import FastDropout

logger = logging.getLogger("isp_tts_tpu_torch")

#: what ``flash: on`` with an explicit attention mask raises with (JAX's words)
FLASH_MASK_ERROR = (
    "flash='on' is incompatible with an explicit attention_mask (the fused kernel "
    "supports key-length/query-length/causal masking only); use flash='auto' or 'off'")


@dataclass
class AttentionConfig:
    dim: int = 256
    heads: int = 4
    head_dim: int | None = 64
    causal: bool = False
    dropout: float = 0.0
    one_kv_head: bool = False
    #: cross-attention's context width (``to_kv``'s input); None: ``dim``
    context_dim: int | None = None
    alibi_pos_bias: bool = False
    alibi_heads: int | None = None
    alibi_symmetric: bool = True
    #: auto | on | off | ring: "ring" rings over the live seq axis and runs
    #: as "auto" without one
    flash: str = "auto"

    def __post_init__(self):
        head_dim = self.head_dim or self.dim // self.heads
        if self.flash != "off" and head_dim > HEAD_DIM_MAX:
            raise NotImplementedError(
                f"head_dim {head_dim}: the port's attention kernels take head dims up to "
                f"{HEAD_DIM_MAX}; set flash: off for the plain version")


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
        self.to_kv = nn.Linear(cfg.context_dim or cfg.dim, 2 * kv_dim, bias=False)
        self.to_out = nn.Linear(q_dim, cfg.dim, bias=False)
        self.dropout = FastDropout(cfg.dropout)
        alibi_heads = cfg.alibi_heads if cfg.alibi_heads is not None else cfg.heads
        if alibi_heads > cfg.heads:
            raise ValueError("alibi_heads must be <= heads")
        self.rel_pos = (LearnedALiBiBias(alibi_heads, cfg.heads, cfg.alibi_symmetric)
                        if cfg.alibi_pos_bias else None)
        self.tp = None
        self._ring_warned = False

    def _ring_group(self, n: int, m: int, local: bool):
        """(True, the seq group) when this call rings; (False, None) when it
        runs locally (no seq axis; ``local``: a call the ring does not take;
        or ``n`` not divisible by the axis)."""
        ctx = get_parallel_context()
        if self.flash != "ring" or ctx.seq_axis is None:
            return False, None
        if local or n != m or n % ctx.seq_size:
            if not self._ring_warned:
                logger.warning("flash='ring': call not ring-compatible (cross-attention, an "
                               "attention mask, a KV cache, or sequence %d not divisible over "
                               "the seq axis of %d); this layer runs locally", n, ctx.seq_size)
                self._ring_warned = True
            return False, None
        return True, ctx.axis_group("seq")

    def _slopes2(self, device) -> torch.Tensor:
        """(2, heads) [lower, upper] slopes; zeros without a relative bias."""
        if self.rel_pos is None:
            return torch.zeros((2, self.heads), device=device)
        return self.rel_pos.slopes2()

    def _keys(self, kv_input, cache, cross):
        """(k, v), each (B, M, Hkv, D): ``to_kv`` of the input, appended to a
        self-attention cache, or a cross-attention cache as it is."""
        if cache is not None and cross:
            return cache
        b, m, _ = kv_input.shape
        hkv = 1 if self.one_kv_head else self.heads
        k, v = self.to_kv(kv_input).chunk(2, dim=-1)  # K first
        k = k.reshape(b, m, hkv, self.head_dim)
        v = v.reshape(b, m, hkv, self.head_dim)
        if cache is not None:
            k = torch.cat([cache[0].to(k.dtype), k], dim=1)
            v = torch.cat([cache[1].to(v.dtype), v], dim=1)
        return k, v

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                context: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                return_cache: bool = False):
        """x (B, N, dim); mask (B, N) bool, True = valid; the rest as the
        module's docstring says. Returns (B, N, dim), or (out, (k, v)) with
        ``return_cache``."""
        b, n, _ = x.shape
        cross = context is not None
        if cache is not None and not cross and mask is not None and n > 1:
            raise ValueError(
                f"a self-attention KV cache with a padding mask takes one query a call, not "
                f"{n}: the (B, 1, 1, N) key mask of the JAX einsum path broadcasts over the "
                "cached keys only at N = 1")
        heads, head0, slopes = self.heads, 0, self._slopes2(x.device)
        if self.tp is not None:
            heads //= self.tp.size
            head0 = self.tp.rank * heads
            slopes = slopes[:, head0:head0 + heads]
            x = copy_to(x, self.tp.group)
            if cross:
                context = copy_to(context, self.tp.group)
        q = self.to_q(x).reshape(b, n, heads, self.head_dim)
        k, v = self._keys(context if cross else x, cache, cross)
        new_cache = (k, v)
        m = k.shape[1]
        if self.one_kv_head:
            k, v = k[:, :, 0], v[:, :, 0]
        else:
            k, v = k[:, :, head0:head0 + heads], v[:, :, head0:head0 + heads]
        # the key mask: the context's, else the padding mask (over a cache:
        # one query's validity for every key)
        key_mask = context_mask if cross else mask
        if key_mask is not None and cache is not None and not cross:
            key_mask = key_mask[:, :1].expand(b, m)
        rate = self.dropout.rate if self.training and drop_params(self.dropout.rate) else 0.0
        flash = self.flash
        if attention_mask is not None and flash == "on":
            raise ValueError(FLASH_MASK_ERROR)
        if attention_mask is not None or (cross and flash in ("auto", "ring")):
            out = self._masked(q, k, v, slopes, key_mask, attention_mask, head0, rate)
            return self._project(out, b, n, heads, mask, new_cache, return_cache)
        q_lens = (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                  else torch.full((b,), n, dtype=torch.int32, device=x.device))
        key_lens = (key_mask.sum(dim=-1, dtype=torch.int32) if key_mask is not None
                    else torch.full((b,), m, dtype=torch.int32, device=x.device))
        seed = self.dropout.draw_seed(x.device) if rate else None
        kwargs = dict(q_lens=q_lens, causal=self.causal, dropout_rate=rate, seed=seed,
                      batch0=batch_origin(b), head0=head0, heads_total=self.heads)
        ring, group = self._ring_group(n, m, cross or cache is not None)
        if ring:
            if self.one_kv_head:
                k, v = k[:, :, None], v[:, :, None]
            q, k, v = (split_seq(t, group, dim=1) for t in (q, k, v))
            out = gather_seq(ring_attention(q, k, v, slopes, key_lens, self.scale,
                                            group=group, **kwargs), group, dim=1)
            return self._project(out, b, n, heads, mask, new_cache, return_cache)
        half = q.dtype == torch.float16 and q.device.type == "cuda" and flash != "off"
        if half:  # the kernels take f32 and bf16: fp16 values are exact in f32
            q, k, v = q.float(), k.float(), v.float()
        args = (q.contiguous(), k.contiguous(), v.contiguous(), slopes.contiguous(),
                key_lens, self.scale, m - n)
        if flash == "off":
            plain = mqa_attention_reference if self.one_kv_head else flash_attention_reference
            out, _ = plain(*args, **kwargs)
        else:
            core = mqa_attention if self.one_kv_head else flash_attention
            out = core(*args, **kwargs)
        if half:
            out = out.half()
        return self._project(out, b, n, heads, mask, new_cache, return_cache)

    def _masked(self, q, k, v, slopes, key_mask, attention_mask, head0, rate):
        """The plain masked path (JAX's einsum path): the key mask and the
        attention mask as one boolean mask, ALiBi at offset M - N with this
        layer's slopes, dropout from the layer's generator. (B, N, h, D)."""
        b, n, heads, _ = q.shape
        m = k.shape[1]
        bool_mask = None
        if key_mask is not None:
            bool_mask = key_mask.bool()[:, None, None, :]  # (B, 1, 1, M)
        if attention_mask is not None:
            am = attention_mask.bool()
            am = am[None, None] if am.dim() == 2 else am[None] if am.dim() == 3 else am
            if am.shape[1] == self.heads and heads != self.heads:
                am = am[:, head0:head0 + heads]  # this rank's heads of a model split
            bool_mask = am if bool_mask is None else bool_mask & am
        bias = None
        if self.rel_pos is not None:
            bias = _geometry(n, m, m - n, slopes, q.device)[2].permute(1, 0, 2)  # (h, N, M)
        drop = None
        if rate:
            def drop(probs):
                thresh, scale = drop_params(rate)
                bits = self.dropout._bits((b, self.heads, n, m), probs.device)
                bits = bits[:, head0:head0 + heads]
                return torch.where(bits < thresh, probs * scale, torch.zeros((), device=probs.device))
        if k.dim() == 3:
            k, v = k[:, :, None], v[:, :, None]
        return masked_attention(q, k, v, self.scale, bias=bias, mask=bool_mask,
                                causal=self.causal, drop=drop)

    def _project(self, out, b, n, heads, mask, new_cache, return_cache):
        """``to_out`` of the core's (B, N, heads, D) output, masked; with
        the new cache when asked."""
        out = out.reshape(b, n, heads * self.head_dim)
        out = (self.to_out(out) if self.tp is None
               else reduce_from(self.to_out(out), self.tp.group))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return (out, new_cache) if return_cache else out
