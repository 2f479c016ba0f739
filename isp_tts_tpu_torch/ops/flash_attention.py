"""Folded multi-query attention forward (kernel K1) and its plain version.

Counterpart of the forward of ``isp_tts_tpu/ops/flash_attention.py:flash_attention_mqa``
(``_mqa_fwd`` -> Pallas ``_mqa_fwd_kernel``); symmetric ALiBi is two equal
slope rows. On a CUDA tensor
:func:`mqa_fwd` launches the hand-written Hopper kernel in
``csrc/mqa_fwd.cu``; on a CPU tensor it runs :func:`mqa_attention_reference`,
the plain einsum version, which is also what the kernel is held against on
the card. Any other device raises. Dropout is a training feature and comes
with the backward (K2); inference never drops.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIM = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset=0,
                            q_lens=None, causal=False):
    """Plain version of K1. Shapes as in :func:`mqa_fwd`; math in f32.

    Returns (o (B, N, H, D) in q's dtype, lse (B, N*H) f32).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    dev = q.device
    s = torch.einsum("bnhd,bmd->bnhm", q.float(), k.float()) * scale
    n = torch.arange(N, device=dev)[:, None]
    c = torch.arange(M, device=dev)[None, :]
    dist = -(c - n - offset).abs().float()  # (N, M)
    lower = c <= n + offset
    sl = slopes.float()
    bias = torch.where(lower[:, None, :], sl[0][None, :, None] * dist[:, None, :],
                       sl[1][None, :, None] * dist[:, None, :])  # (N, H, M)
    s = s + bias[None]
    valid = c[None] < key_lens.to(dev)[:, None, None]  # (B, 1, M)
    if causal:
        valid = valid & lower[None]
    valid = valid[:, :, None, :]  # (B, N|1, 1, M)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnhm,bmd->bnhd", p, v.float()) / l.clamp_min(1e-30)
    if q_lens is None:
        q_lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    q_live = torch.arange(N, device=dev)[None, :] < q_lens.to(dev)[:, None]
    live = q_live[:, :, None, None] & (l > 0)
    o = torch.where(live, o, torch.zeros((), device=dev)).to(q.dtype)
    lse = torch.where(live[..., 0], m[..., 0] + torch.log(l.clamp_min(1e-30))[..., 0],
                      torch.full((), float("inf"), device=dev))
    return o, lse.reshape(B, N * H)


def _check(q, k, v, slopes, key_lens, q_lens):
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q must be (B, N, H, D) and k, v (B, M, D)")
    B, N, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"K1 takes head dim {HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    if k.shape != (B, k.shape[1], D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if slopes.shape != (2, H) or slopes.dtype != torch.float32:
        raise ValueError(f"slopes must be (2, {H}) float32")
    for name, lens in (("key_lens", key_lens), ("q_lens", q_lens)):
        if lens.shape != (B,) or lens.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B},) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("slopes", slopes),
                    ("key_lens", key_lens), ("q_lens", q_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _kernel():
    """The built K1 entry point, with its C signature declared."""
    from .cuda_build import load

    fn = load("mqa_fwd").isp_mqa_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, slopes, key_lens, q_lens, scale, offset, causal):
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((B, N * H), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                 key_lens.data_ptr(), q_lens.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, N, M, H, int(offset), int(bool(causal)),
                 float(scale), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"K1 mqa_fwd launch failed: CUDA error {err}")
    mqa_fwd.launches += 1
    return o, lse


def mqa_fwd(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
            causal=False):
    """Folded-MQA attention forward.

    Args:
      q: (B, N, H, 64) float32 or bfloat16; row n*H + h is query n, head h.
      k, v: (B, M, 64), q's dtype — the one shared key/value head.
      slopes: (2, H) float32 [lower, upper] ALiBi slopes (equal rows for
        symmetric ALiBi; zeros disable the bias).
      key_lens: (B,) int32 valid key counts.
      scale: logit scale. offset: the query-to-key diagonal offset.
      q_lens: optional (B,) int32 valid query counts; rows past them give 0.
      causal: query n attends keys <= n + offset only.

    Returns:
      (o (B, N, H, 64) in q's dtype, lse (B, N*H) float32 row logsumexp,
      +inf on rows that attended nothing).
    """
    if q_lens is None:
        q_lens = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                            device=q.device)
    if q.device.type == "cpu":
        return mqa_attention_reference(q, k, v, slopes, key_lens, scale,
                                       offset, q_lens, causal)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v, slopes, key_lens, q_lens)
    return _launch(q, k, v, slopes, key_lens, q_lens, scale, offset, causal)


#: kernel launches since the count was last set to 0 (CPU calls never count)
mqa_fwd.launches = 0
