"""Plain scaled-dot-product attention with an additive bias.

Counterpart of ``isp_tts_tpu/ops/attention.py`` (the einsum path that the
JAX package runs on the CPU). Fully masked query rows give zeros.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def scaled_dot_product_attention(q, k, v, *, scale=None, bias=None, mask=None,
                                 causal=False):
    """q (B, H, N, D); k, v (B, Hkv, M, D) with Hkv 1 or H; bias and bool
    mask (True = attend) broadcastable to (B, H, N, M). Returns (B, H, N, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(),
                          k.float().expand(-1, q.shape[1], -1, -1)) * scale
    if bias is not None:
        logits = logits + bias.float()
    n, m = q.shape[-2], k.shape[-2]
    if causal:
        row = torch.arange(n, device=q.device)[:, None] + (m - n)
        causal_mask = torch.arange(m, device=q.device)[None, :] <= row
        mask = causal_mask if mask is None else mask & causal_mask
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    if mask is not None:
        unnorm = unnorm * mask
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhnm,bhmd->bhnd", probs,
                       v.float().expand(-1, q.shape[1], -1, -1))
    return out.to(q.dtype)
