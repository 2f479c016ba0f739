"""Banded ordered-label CTC (kernel K4: forward and backward) and its plain
version.

Counterpart of ``isp_tts_tpu/ops/ctc_pallas.py`` (``_fwd_kernel`` +
``_bwd_kernel``, wrappers ``_run_fwd`` / ``_ctc_bwd``, joined by a
``custom_vjp``) and of the scan it replaces,
``isp_tts_tpu/models/acoustic/loss.py:_ordered_ctc_neg_logp``. The labels
are always [1..text_len], each distinct, so the CTC lattice is two state
vectors of width W = T + 1 (blank after j labels; emitting label j+1)
streamed over frames; see ``csrc/ctc.cu``.

:func:`ordered_ctc_neg_logp` is differentiable. On CUDA tensors its
forward is :func:`ctc_fwd`, which keeps every frame's alphas, and its
backward :func:`ctc_bwd`, the beta recursion; both keep the state
recursion, the alphas and log Z in float64: the states grow to
~mel_len * |log p|, where float32 rounding would reach the gradient as a
relative error of ~1e-3 at mel 1024. On CPU tensors it runs the plain
version, :func:`ordered_ctc_neg_logp_reference` (the port of the JAX scan)
in float64, differentiated by autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.autocast import no_autocast
from .cuda_build import launch_stream

NEG = -1e30


def _edge(x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0], 1), NEG, dtype=x.dtype, device=x.device)


def _readout(blank, label, text_lens):
    """log Z = logaddexp(blank_L, label_{L-1}), L = clip(text_len, 1, T)."""
    idx = text_lens.long().clamp(1, blank.shape[1] - 1)[:, None]
    return torch.logaddexp(blank.gather(1, idx), label.gather(1, idx - 1))[:, 0]


def _recursion(lpf, mel_lens):
    """The forward recursion in ``lpf``'s dtype; returns the final (blank,
    label) state vectors."""
    B, M, W = lpf.shape
    col = torch.arange(W, device=lpf.device)
    blank = torch.where(col == 0, 0.0, NEG).to(lpf.dtype).expand(B, W)
    label = torch.full((B, W), NEG, dtype=lpf.dtype, device=lpf.device)
    edge = _edge(lpf)
    ml = mel_lens.to(lpf.device)
    for t in range(M):
        lp = lpf[:, t]
        c = torch.logaddexp(blank, torch.cat([edge, label[:, :-1]], dim=1))
        new_blank = c + lp[:, :1]
        new_label = torch.logaddexp(label, c) + torch.cat([lp[:, 1:], edge], dim=1)
        v = (t < ml)[:, None]
        blank = torch.where(v, new_blank, blank)
        label = torch.where(v, new_label, label)
    return blank, label


@no_autocast
def ordered_ctc_neg_logp_reference(logprobs, text_lens, mel_lens):
    """-log p([1..text_len] | logprobs) under CTC, (B,), in ``logprobs``'
    dtype: the JAX package's scan (``_ordered_ctc_neg_logp``),
    differentiable by autograd. The plain path's CTC runs it in float32, as
    there; K4's plain version runs it in float64.

    logprobs: (B, M, T+1) log-softmaxed, blank at column 0.
    """
    blank, label = _recursion(logprobs, mel_lens)
    return -_readout(blank, label, text_lens.to(logprobs.device))


def _check(logprobs, *others):
    if logprobs.dim() != 3 or logprobs.dtype != torch.float32:
        raise TypeError("K4 takes (B, M, T+1) float32 log-probabilities")
    B, _, W = logprobs.shape
    if not 2 <= W <= 1024:
        raise ValueError(f"K4 holds a row in at most 32 warps, a column a lane: T+1 = {W} "
                         "not in [2, 1024]")
    for t in others:
        if t.device != logprobs.device or not t.is_contiguous():
            raise ValueError(f"K4 arguments must be contiguous on {logprobs.device}")
    if not logprobs.is_contiguous():
        raise ValueError("logprobs must be contiguous")


def _fn(symbol: str, n_ptr: int):
    from .cuda_build import load

    fn = getattr(load("ctc"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ctc_fwd(logprobs, text_lens, mel_lens):
    """K4 forward: (neg_logp (B,) f32, alphas_blank and alphas_label
    (B, M, W) f64, log Z (B,) f64). Alphas of frames at or past mel_len are
    not written."""
    if logprobs.device.type != "cuda":
        raise ValueError(f"K4 launches on cuda tensors, not {logprobs.device}")
    B, M, W = logprobs.shape
    for lens in (text_lens, mel_lens):
        if lens.shape != (B,) or lens.dtype != torch.int32:
            raise ValueError(f"lengths must be ({B},) int32")
    _check(logprobs, text_lens, mel_lens)
    ab = torch.empty_like(logprobs, dtype=torch.float64)
    al = torch.empty_like(ab)
    logz = torch.empty((B,), dtype=torch.float64, device=logprobs.device)
    neg = torch.empty((B,), dtype=torch.float32, device=logprobs.device)
    with launch_stream(logprobs.device) as stream:
        err = _fn("isp_ctc_fwd", 7)(logprobs.data_ptr(), text_lens.data_ptr(),
                                    mel_lens.data_ptr(), ab.data_ptr(), al.data_ptr(),
                                    logz.data_ptr(), neg.data_ptr(), B, M, W, stream)
    if err != 0:
        raise RuntimeError(f"K4 ctc_fwd launch failed: CUDA error {err}")
    ctc_fwd.launches += 1
    return neg, ab, al, logz


def ctc_bwd(logprobs, ab, al, logz, g, text_lens, mel_lens):
    """K4 backward: d(sum_b g[b] * neg_logp[b]) / d logprobs, (B, M, W)."""
    if logprobs.device.type != "cuda":
        raise ValueError(f"K4 launches on cuda tensors, not {logprobs.device}")
    g = g.float().contiguous()
    _check(logprobs, ab, al, logz, g, text_lens, mel_lens)
    B, M, W = logprobs.shape
    if ab.shape != (B, M, W) or al.shape != ab.shape or logz.shape != (B,) or any(
            x.dtype != torch.float64 for x in (ab, al, logz)):
        raise ValueError("alphas and log Z must be K4's forward's float64 outputs")
    dlp = torch.empty_like(logprobs)
    with launch_stream(logprobs.device) as stream:
        err = _fn("isp_ctc_bwd", 8)(logprobs.data_ptr(), ab.data_ptr(), al.data_ptr(),
                                    logz.data_ptr(), g.data_ptr(), text_lens.data_ptr(),
                                    mel_lens.data_ptr(), dlp.data_ptr(), B, M, W, stream)
    if err != 0:
        raise RuntimeError(f"K4 ctc_bwd launch failed: CUDA error {err}")
    ctc_bwd.launches += 1
    return dlp


#: kernel launches since the counts were last set to 0
ctc_fwd.launches = 0
ctc_bwd.launches = 0


class _OrderedCTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logprobs, text_lens, mel_lens):
        neg, ab, al, logz = ctc_fwd(logprobs, text_lens, mel_lens)
        ctx.save_for_backward(logprobs, ab, al, logz, text_lens, mel_lens)
        return neg

    @staticmethod
    def backward(ctx, g):
        logprobs, ab, al, logz, text_lens, mel_lens = ctx.saved_tensors
        return ctc_bwd(logprobs, ab, al, logz, g, text_lens, mel_lens), None, None


def ordered_ctc_neg_logp(logprobs, text_lens, mel_lens):
    """-log p([1..text_len] | logprobs), (B,) float32, differentiable in
    logprobs: K4's forward and backward on CUDA tensors; on CPU tensors its
    plain version, autograd through the float64 recursion.

    logprobs: (B, M, T+1) float32 log-softmaxed, blank at column 0;
    text_lens, mel_lens: (B,) int32.
    """
    if logprobs.device.type == "cpu":
        return ordered_ctc_neg_logp_reference(logprobs.double(), text_lens,
                                              mel_lens).float()
    return _OrderedCTC.apply(logprobs.contiguous(), text_lens, mel_lens)
