"""Mask utilities (counterpart of ``isp_tts_tpu/utils/masks.py``)."""

from __future__ import annotations

import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """bool (B, max_len), True on positions below each length."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] < lengths[:, None]


def get_float_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """f32 (B, max_len): position i gets clamp(length - i, 0, 1)."""
    ids = torch.arange(max_len, device=lengths.device, dtype=torch.float32)
    return (lengths.float()[:, None] - ids[None, :]).clamp(0.0, 1.0)


def get_mask_3d(widths: torch.Tensor, heights: torch.Tensor, max_w: int,
                max_h: int) -> torch.Tensor:
    """bool (B, max_w, max_h): the outer product of two length masks."""
    mask_w = get_mask_from_lengths(widths, max_w)
    mask_h = get_mask_from_lengths(heights, max_h)
    return mask_w[:, :, None] & mask_h[:, None, :]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean over the batch of per-sample masked means (each sample weighs
    the same whatever its length), as the JAX package's ``masked_mean``."""
    mask = mask.expand(x.shape).to(x.dtype)
    axes = tuple(range(1, x.dim())) if x.dim() > 1 else (0,)
    return ((x * mask).sum(dim=axes) / mask.sum(dim=axes).clamp_min(eps)).mean()
