"""Transformer layer and stack (counterpart of ``isp_tts_tpu/nn/transformer.py``).

Every layer's attention takes the JAX call's arguments: a padding mask,
cross-attention's ``context``/``context_mask``, an explicit
``attention_mask`` and a KV ``cache`` (one (k, v) a layer); with
``return_cache`` the stack returns a :class:`TransformerOutput` holding
the layers' new caches, else its output tensor alone.

Two layouts of the layer stack, as there:

- per layer (``layers.<i>.*``), the default;
- stacked (``pipeline: true``): one :class:`TransformerLayer` under
  ``stack.*`` whose every parameter carries a leading depth axis (the JAX
  state path ``stack.*``), run layer by layer through
  ``torch.func.functional_call`` on each layer's slice. Under a live stage
  axis (the parallel context's ``stage_axis``) each rank holds only its
  ``depth / S`` layers (``parallel.mesh.shard_stages``) and the stack runs
  the GPipe schedule (``parallel.pipeline.pipeline_apply``) over
  ``n_micro`` microbatches; with no stage axis the whole batch runs as
  one microbatch layer by layer here (the same schedule at one stage), so
  a pipeline-trained checkpoint serves on one card. A batch that
  ``n_micro`` does not divide raises under a live stage axis of more than
  one rank and runs as one microbatch at one. Beside a model axis each
  stage's stacked tensors are also split over the model ranks
  (``parallel.mesh.shard_params``, the split dim past the depth axis), and
  each depth slice runs split. A stacked stack takes
  self-attention with a padding mask only: the other arguments raise, as
  there.

Dropout inside a stacked stack cannot follow JAX's
``fold_in(base, layer * n_micro + mb)`` keys, which torch cannot
reproduce. It has its own scheme: a per-step base seed taken from the
model's shared generator (hashed from its host-side state, so the host
never waits on the device for it), and for layer g a generator seeded from (base,
g) that draws at the global batch's rows, of which each microbatch keeps
its own (``parallel.context.row_window``; the attention kernels' hash is
placed at the microbatch's first global row). So what a stacked stack
drops depends on the step, the layer and the global row alone: not on the
microbatch count, the stage count or the data split.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch import nn

from ..config import as_dict, build_config
from ..ops.flash_attention import drop_params
from ..parallel.context import batch_origin, get_parallel_context, row_window
from ..parallel.pipeline import microbatch, pipeline_apply
from .attention import Attention, AttentionConfig
from .embeddings import fixed_positional_embedding
from .feedforward import FeedForward, FeedForwardConfig
from .layers import FastDropout, set_dropout_generator
from .norms import AdaptiveLayerNorm, LayerNorm

_M63 = 2**63 - 1

#: what a stacked stack raises with on what it does not take (JAX's words)
STACKED_ONLY = ("pipeline=True transformers support self-attention with a padding mask "
                "only (no cross-attention / explicit attention masks / AdaLN / KV caches)")


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

    def forward(self, x, mask=None, adaptive_condition=None, context=None, context_mask=None,
                attention_mask=None, cache=None, return_cache=False):
        """(B, N, dim) out; with ``return_cache`` (out, the attention's (k, v))."""
        if self.adaptive_norm and adaptive_condition is None:
            raise ValueError("adaptive_condition must be provided for AdaptiveLayerNorm")
        fmask = mask[..., None].to(x.dtype) if mask is not None else None
        residual = x
        out = self.attention_norm(x, adaptive_condition) if self.pre_norm else x
        out = self.attention(out, mask=mask, context=context, context_mask=context_mask,
                             attention_mask=attention_mask, cache=cache,
                             return_cache=return_cache)
        if return_cache:
            out, new_cache = out
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
        return (out, new_cache) if return_cache else out


class TransformerOutput(NamedTuple):
    """A stack's output with the layers' KV caches (``return_cache``)."""

    out: torch.Tensor
    cache: list | None = None


@dataclass
class TransformerConfig:
    dim: int = 384
    depth: int = 6
    transformer_layer: TransformerLayerConfig = field(default_factory=TransformerLayerConfig)
    emb_dim: int | None = None
    use_abs_pos_emb: bool = True
    adaptive_norm: bool = False
    condition_dim: int | None = None
    #: stacked layer storage (``stack.*``, a leading depth axis) run as a
    #: GPipe schedule over a live stage axis, locally otherwise
    pipeline: bool = False


def _stacked_layer(layers: list[nn.Module]) -> nn.Module:
    """The first of ``layers`` with each parameter replaced by every
    layer's value of it stacked along a new leading axis."""
    stack = layers[0]
    per_layer = [dict(layer.named_parameters()) for layer in layers]
    for name in list(per_layer[0]):
        prefix, _, leaf = name.rpartition(".")
        owner = stack.get_submodule(prefix) if prefix else stack
        owner._parameters[leaf] = nn.Parameter(
            torch.stack([p[name].detach() for p in per_layer]))
    return stack


class Transformer(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = config
        self.emb_dim = cfg.emb_dim or cfg.dim
        self.depth = cfg.depth
        layer_cfg = build_config(
            TransformerLayerConfig, as_dict(cfg.transformer_layer), dim=cfg.dim,
            adaptive_norm=cfg.adaptive_norm, condition_dim=cfg.condition_dim)
        layers = [TransformerLayer(layer_cfg) for _ in range(cfg.depth)]
        if cfg.pipeline:
            if cfg.adaptive_norm:
                raise ValueError(STACKED_ONLY)
            self.layers = None
            self.stack = _stacked_layer(layers)
            #: (first global layer, layers) this rank holds (shard_stages)
            self.stage_layers = (0, cfg.depth)
            #: draws the per-step base seed of the stack's dropout from the
            #: model's shared generator (set_dropout_generator reaches it)
            self.step_dropout = FastDropout(0.0)
            self._layer_gens: dict = {}
            first_layer = self.stack
        else:
            self.layers = nn.ModuleList(layers)
            self.stack = None
            first_layer = self.layers[0]
        has_rel_pos = first_layer.attention.rel_pos is not None
        self.use_abs_pos_emb = cfg.use_abs_pos_emb and not has_rel_pos
        self.project_emb = (nn.Linear(self.emb_dim, cfg.dim)
                            if self.emb_dim != cfg.dim else None)
        # flax's nnx.LayerNorm default epsilon
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6) if layer_cfg.pre_norm else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                adaptive_condition: torch.Tensor | None = None,
                context: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None,
                attention_mask: torch.Tensor | None = None,
                cache: list | None = None, return_cache: bool = False):
        """x (B, N, emb_dim); mask (B, N). ``context``/``context_mask``,
        ``attention_mask`` and ``cache`` (one (k, v) a layer) reach every
        layer's attention. Returns (B, N, dim), or a
        :class:`TransformerOutput` with the layers' new caches when
        ``return_cache``. A stacked stack takes self-attention with a
        padding mask only, as the JAX package's."""
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
        new_caches = []
        if self.stack is not None:
            if (context is not None or attention_mask is not None
                    or adaptive_condition is not None or cache is not None or return_cache):
                raise ValueError(STACKED_ONLY)
            x = self._stacked_forward(x, mask)
        else:
            for i, layer in enumerate(self.layers):
                x = layer(x, mask=mask, adaptive_condition=adaptive_condition, context=context,
                          context_mask=context_mask, attention_mask=attention_mask,
                          cache=cache[i] if cache is not None else None,
                          return_cache=return_cache)
                if return_cache:
                    x, layer_cache = x
                    new_caches.append(layer_cache)
        if self.norm is not None:
            x = self.norm(x.float())
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return TransformerOutput(out=x, cache=new_caches) if return_cache else x

    # -- the stacked layer stack -------------------------------------------------

    def _dropout_on(self) -> bool:
        return self.training and any(
            isinstance(m, FastDropout) and drop_params(m.rate) is not None
            for m in self.stack.modules())

    def _layer_generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        if key not in self._layer_gens:
            self._layer_gens[key] = torch.Generator(device=device)
        return self._layer_gens[key]

    def _step_base(self, device: torch.device) -> int:
        """The per-step base seed of the stack's dropout, with no device
        sync: the shared generator is advanced by one draw, then its state
        (host-side for every device's generator) is hashed on the host."""
        self.step_dropout.draw_seed(device)
        gen = self.step_dropout.generator
        if gen is None:
            gen = (torch.cuda.default_generators[device.index or 0]
                   if device.type == "cuda" else torch.default_generator)
        return zlib.crc32(gen.get_state().numpy().tobytes())

    def _stacked_forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """The stacked layers: the GPipe schedule over the stage group when
        the context names a stage axis, else the whole batch as one
        microbatch layer by layer on this device (the schedule of one
        stage)."""
        ctx = get_parallel_context()
        B = x.shape[0]
        piped = ctx.stage_axis is not None
        group = ctx.axis_group("stage") if piped else None
        S = ctx.stage_size if piped else 1
        first, per = self.stage_layers
        if per * S != self.depth:
            raise RuntimeError(f"a stage of {S} holds {per} of {self.depth} layers: cut the "
                               "stack with parallel.mesh.shard_stages")
        if not piped:
            n_micro = 1
        elif ctx.n_micro > 0 and B % ctx.n_micro == 0:
            n_micro = ctx.n_micro
        elif S > 1:
            raise ValueError(f"pipeline batch {B} not divisible by pipeline_microbatches="
                             f"{ctx.n_micro}")
        else:
            n_micro = 1
        Bm = B // n_micro
        drop = self._dropout_on()
        gen = self._layer_generator(x.device) if drop else None
        base = self._step_base(x.device) if drop else 0
        total, row0 = B * ctx.data_size, batch_origin(B)
        params = dict(self.stack.named_parameters())
        masks = microbatch(mask, n_micro) if mask is not None else None

        def run_layer(j: int, h: torch.Tensor, mb: int) -> torch.Tensor:
            if drop:
                gen.manual_seed((base * 1_000_003 + (first + j) * 7919 + 1) & _M63)
                set_dropout_generator(self.stack, gen)
            with row_window(total, row0 + mb * Bm):
                return torch.func.functional_call(
                    self.stack, {n: p[j] for n, p in params.items()}, (h,),
                    {"mask": masks[mb] if masks is not None else None})

        def stage_fn(h: torch.Tensor, mb: int) -> torch.Tensor:
            for j in range(per):
                h = run_layer(j, h, mb)
            return h

        out = pipeline_apply(stage_fn, microbatch(x, n_micro), group=group, remat=piped)
        return out.reshape(x.shape)
