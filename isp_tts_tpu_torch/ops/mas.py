"""Monotonic alignment search (kernel K3) and its plain version.

Counterpart of ``isp_tts_tpu/ops/mas.py:monotonic_alignment_search`` (the
f32 Viterbi DP and backtrack) and of the Pallas pair in
``isp_tts_tpu/ops/mas_pallas.py`` (``_fwd_kernel`` + ``_bwd_kernel``,
wrapper ``monotonic_alignment_search_pallas``). On a CUDA tensor
:func:`monotonic_alignment_search` launches the hand-written kernel in
``csrc/mas.cu``; on a CPU tensor it runs
:func:`monotonic_alignment_search_reference`, which the kernel matches bit
for bit on the card. :func:`mas_numpy` is a copy of the JAX package's
float64 test oracle. MAS has no gradient: callers pass detached maps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.autocast import no_autocast

NEG_INF = -1e9


@no_autocast
def monotonic_alignment_search_reference(log_attn: torch.Tensor,
                                         text_lens: torch.Tensor,
                                         mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (B, M, T) log-probabilities -> (B, M, T) f32
    one-hot hard alignment, monotonic from token 0 to token text_len - 1;
    rows at or past mel_len are zero."""
    B, M, T = log_attn.shape
    dev = log_attn.device
    col = torch.arange(T, device=dev)
    a = torch.where((col[None, :] < text_lens[:, None])[:, None, :],
                    log_attn.float(), NEG_INF)
    lp = torch.where(col[None, :] == 0, a[:, 0], NEG_INF)
    diag = torch.zeros((B, M, T), dtype=torch.bool, device=dev)
    edge = torch.full((B, 1), NEG_INF, device=dev)
    for i in range(1, M):
        shifted = torch.cat([edge, lp[:, :-1]], dim=1)
        diag[:, i] = shifted >= lp
        lp = a[:, i] + torch.maximum(shifted, lp)

    rows = torch.arange(B, device=dev)
    ml = mel_lens.to(dev).long()
    j = text_lens.to(dev).long() - 1
    path = torch.full((B, M), -1, dtype=torch.long, device=dev)
    for i in range(M - 1, -1, -1):
        active = i < ml
        path[:, i] = torch.where(active, j, -1)
        if i > 0:
            back = diag[rows, i, j.clamp_min(0)].long()
            j = torch.where(active, (j - back).clamp_min(0), j)
    return (path[:, :, None] == col[None, None, :]).float()


def monotonic_alignment_search(log_attn: torch.Tensor, text_lens: torch.Tensor,
                               mel_lens: torch.Tensor) -> torch.Tensor:
    """MAS: (B, M, T) float32 log-attention, (B,) int32 lengths -> (B, M, T)
    float32 one-hot alignment (kernel K3 on a CUDA tensor)."""
    if log_attn.device.type == "cpu":
        return monotonic_alignment_search_reference(log_attn, text_lens, mel_lens)
    if log_attn.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu tensors, not {log_attn.device}")
    if log_attn.dim() != 3 or log_attn.dtype != torch.float32:
        raise TypeError("K3 takes a (B, M, T) float32 map")
    B, M, T = log_attn.shape
    if T > 6144:
        raise ValueError(f"K3 holds a DP row in at most 24 warps' registers: T {T} > 6144")
    for name, t in (("log_attn", log_attn), ("text_lens", text_lens),
                    ("mel_lens", mel_lens)):
        if t.device != log_attn.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {log_attn.device}")
    for lens in (text_lens, mel_lens):
        if lens.shape != (B,) or lens.dtype != torch.int32:
            raise ValueError(f"lengths must be ({B},) int32")
    out = torch.empty_like(log_attn)
    if out.numel() == 0:
        return out
    lib = _library()
    # the choice bits go to global scratch where they do not fit in shared memory
    bits = torch.empty((B * lib.isp_mas_scratch_bytes(M, T),), dtype=torch.uint8,
                       device=log_attn.device)
    with torch.cuda.device(log_attn.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.isp_mas(log_attn.data_ptr(), text_lens.data_ptr(), mel_lens.data_ptr(),
                      bits.data_ptr(), out.data_ptr(), B, M, T, stream)
    if err != 0:
        raise RuntimeError(f"K3 mas launch failed: CUDA error {err}")
    monotonic_alignment_search.launches += 1
    return out


def _library():
    from .cuda_build import load

    lib = load("mas")
    if lib.isp_mas.argtypes is None:
        lib.isp_mas.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.isp_mas.restype = ctypes.c_int
        lib.isp_mas_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.isp_mas_scratch_bytes.restype = ctypes.c_longlong
    return lib


#: kernel launches since the count was last set to 0 (CPU calls never count)
monotonic_alignment_search.launches = 0


def mas_numpy(log_attn: np.ndarray, text_lens: np.ndarray,
              mel_lens: np.ndarray) -> np.ndarray:
    """Slow, obviously-correct host oracle for tests (per-element Viterbi in
    float64), a copy of the JAX package's."""
    B, M, T = log_attn.shape
    out = np.zeros((B, M, T), dtype=np.float32)
    for b in range(B):
        tl, ml = int(text_lens[b]), int(mel_lens[b])
        lp = np.full((ml, tl), -np.inf, dtype=np.float64)
        lp[0, 0] = log_attn[b, 0, 0]
        for i in range(1, ml):
            for j in range(tl):
                best = lp[i - 1, j]
                if j > 0 and lp[i - 1, j - 1] >= best:
                    best = lp[i - 1, j - 1]
                lp[i, j] = log_attn[b, i, j] + best
        j = tl - 1
        for i in range(ml - 1, -1, -1):
            out[b, i, j] = 1.0
            if i > 0 and j > 0 and lp[i - 1, j - 1] >= lp[i - 1, j]:
                j -= 1
    return out
