"""Text-to-mel aligner: conv key/query projections, diagonal prior, MAS.

Counterpart of ``isp_tts_tpu/models/acoustic/aligner.py`` (the local path,
``Aligner._attention_local`` and ``__call__``). The JAX package splits
the aligner's batch over every live mesh axis (``_attention_manual``)
when the model axis is 1 and dropout is off; here each seq or stage peer
computes it whole on its data rank's rows (the same values; the peers'
gradients of it are equal, so nothing sums them); a batch norm
(``normalization: batch``) takes its statistics over the data group's
global batch, as the JAX package's sharded sums do. Channel-last (B, T, C) at the module's
edges, as in the JAX package; the convolutions run channel-first inside.
Hard alignment is kernel K3 (``ops/mas.py``) on CUDA tensors with
``mas_impl`` "auto" or "pallas", and the plain DP with "scan".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import FastDropout, choose_activation, choose_normalization
from ...ops.mas import monotonic_alignment_search, monotonic_alignment_search_reference
from ...utils.autocast import no_autocast
from ...utils.masks import get_mask_from_lengths

NEG_INF = -1e9


@no_autocast
def batch_diagonal_prior(text_lens: torch.Tensor, mel_lens: torch.Tensor,
                         max_text_len: int, max_mel_len: int, gamma: float = 0.1,
                         threshold: float = 1e-4) -> torch.Tensor:
    """Diagonal Gaussian alignment prior, (B, M, T), rows normalised over T."""
    dev = text_lens.device
    grid_text = torch.arange(max_text_len, device=dev, dtype=torch.float32)[None, :] \
        / text_lens.float()[:, None]
    grid_mel = torch.arange(max_mel_len, device=dev, dtype=torch.float32)[None, :] \
        / mel_lens.float()[:, None]
    grid = grid_text[:, None, :] - grid_mel[:, :, None]
    prior = torch.exp(-(grid ** 2) / (2.0 * gamma ** 2))
    text_mask = get_mask_from_lengths(text_lens, max_text_len)
    mel_mask = get_mask_from_lengths(mel_lens, max_mel_len)
    prior = prior * text_mask[:, None, :] * mel_mask[:, :, None]
    prior = prior / (prior.sum(dim=-1, keepdim=True) + 1e-5)
    return torch.where(prior < threshold, 0.0, prior)


class ConvBlock1D(nn.Module):
    """Conv1d ("SAME" padding) -> activation -> masked norm (instance or
    batch: ``choose_normalization``) -> dropout, with padded positions
    zeroed before the convolution. The convolution has a bias only without
    a norm, as there."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 bias: bool = True, activation: str = "relu",
                 normalization: str | None = "instance", dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              bias=bias and normalization is None)
        # flax "SAME": (k - 1) // 2 before, the rest after
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.act = choose_activation(activation)
        norm_cls = choose_normalization(normalization)
        self.norm = norm_cls(out_channels) if norm_cls is not None else None
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C_in); mask: (B, T) True = valid."""
        x = x * mask[..., None].to(x.dtype)
        y = self.conv(F.pad(x.transpose(1, 2), self.pad)).transpose(1, 2)
        y = self.act(y)
        if self.norm is not None:
            y = self.norm(y, mask)
        return self.dropout(y)


@dataclass
class AlignerConfig:
    mel_dim: int = 80
    text_dim: int = 512
    attention_dim: int = 80
    key_kernel_size: int = 3
    query_kernel_size: int | Sequence[int] = (3, 3)
    dropout: float = 0.0
    normalization: str | None = "instance"
    activation: str = "relu"
    attention_prior: bool = True
    mas_impl: str = "auto"  # auto | pallas: kernel K3; scan: the plain DP


class AlignerOutput(NamedTuple):
    attn_soft: torch.Tensor  # (B, M, T)
    attn_logits: torch.Tensor  # (B, M, T)
    attn_hard: torch.Tensor  # (B, M, T)
    attn_hard_duration: torch.Tensor  # (B, T)


class Aligner(nn.Module):
    def __init__(self, config: AlignerConfig):
        super().__init__()
        cfg = config
        if cfg.mas_impl not in ("auto", "pallas", "scan"):
            raise ValueError(f"unknown mas_impl {cfg.mas_impl!r}")
        self.config = cfg
        self.scale = cfg.attention_dim ** -0.5

        def block(cin, cout, k, act, norm):
            return ConvBlock1D(cin, cout, kernel_size=k, bias=False, activation=act,
                               normalization=norm, dropout=cfg.dropout)

        qk = cfg.query_kernel_size
        if isinstance(qk, int):
            qk = (qk, qk)
        self.key_proj = nn.ModuleList([
            block(cfg.text_dim, cfg.text_dim * 2, cfg.key_kernel_size, cfg.activation,
                  cfg.normalization),
            block(cfg.text_dim * 2, cfg.attention_dim, 1, "linear", None),
        ])
        self.query_proj = nn.ModuleList([
            block(cfg.mel_dim, cfg.mel_dim * 2, qk[0], cfg.activation, cfg.normalization),
            block(cfg.mel_dim * 2, cfg.mel_dim, qk[1], cfg.activation, cfg.normalization),
            block(cfg.mel_dim, cfg.attention_dim, 1, "linear", None),
        ])

    def attention(self, mel, enc_text, mel_len, text_len):
        """(attn_soft, attn_logits), both (B, M, T) f32: mel frames
        (B, M, mel_dim) query encoder text states (B, T, text_dim)."""
        M, T = mel.shape[1], enc_text.shape[1]
        key_mask = get_mask_from_lengths(text_len, T)
        query_mask = get_mask_from_lengths(mel_len, M)
        keys = enc_text
        for conv in self.key_proj:
            keys = conv(keys, key_mask)
        queries = mel
        for conv in self.query_proj:
            queries = conv(queries, query_mask)
        return self._maps(queries, keys, key_mask, query_mask, text_len, mel_len)

    @no_autocast
    def _maps(self, queries, keys, key_mask, query_mask, text_len, mel_len):
        # products of the (bf16 under autocast) projections, summed in f32
        # as the JAX package's preferred_element_type=f32 einsum
        attn = torch.einsum("bma,bta->bmt", queries.float(), keys.float()) * self.scale
        if self.config.attention_prior:
            prior = batch_diagonal_prior(text_len, mel_len, attn.shape[2], attn.shape[1])
            # log_softmax over ALL text columns, before the key mask: padded
            # columns keep finite values, which the CTC loss depends on
            attn = attn.log_softmax(dim=2) + torch.log(prior + 1e-6)
        attn_logits = attn
        attn = attn.masked_fill(~key_mask[:, None, :], NEG_INF)
        attn_soft = attn.softmax(dim=2) * key_mask[:, None, :] * query_mask[:, :, None]
        return attn_soft, attn_logits

    def forward(self, mel, enc_text, mel_len, text_len) -> AlignerOutput:
        attn_soft, attn_logits = self.attention(mel, enc_text, mel_len, text_len)
        mas = (monotonic_alignment_search_reference if self.config.mas_impl == "scan"
               else monotonic_alignment_search)
        attn_hard = mas(attn_logits.detach().contiguous(), text_len.to(torch.int32),
                        mel_len.to(torch.int32))
        duration = attn_hard.sum(dim=1)
        # assign any deficit to the first token; a no-op when the durations
        # already sum to mel_len
        deficit = mel_len.to(duration.dtype) - duration.sum(dim=1)
        duration = torch.cat([duration[:, :1] + deficit[:, None], duration[:, 1:]], dim=1)
        return AlignerOutput(attn_soft=attn_soft, attn_logits=attn_logits,
                             attn_hard=attn_hard, attn_hard_duration=duration)
