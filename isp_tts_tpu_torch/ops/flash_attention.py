"""Attention kernels and their plain versions: the folded-MQA forward (K1)
and backward (K2), the per-head forward (K5a) and backward (K5b), and the
autograd function that joins a forward to its backward.

Counterpart of ``isp_tts_tpu/ops/flash_attention.py``:

- ``flash_attention_mqa`` (one key/value head): the forward ``_mqa_fwd``
  (Pallas ``_mqa_fwd_kernel``) and the backward ``_mqa_bwd`` (Pallas
  ``_mqa_dfused_kernel`` when the key axis fits resident,
  ``_mqa_dq_kernel`` + ``_mqa_dkv_kernel`` above it). On a CUDA tensor
  :func:`mqa_fwd` launches ``csrc/mqa_fwd.cu`` and :func:`mqa_bwd`
  ``csrc/mqa_bwd.cu`` (one design for both TPU regimes). The forwards share
  one tensor-core tile core (``csrc/attention_fwd.cuh``), the backwards
  another (``csrc/attention_bwd.cuh``).
- ``flash_attention`` (Hkv key/value heads, Hkv = H or 1): the forward
  ``_flash_fwd`` (Pallas ``_fwd_kernel``) and the backward ``_flash_bwd``
  (``_dq_kernel`` + ``_dkv_kernel``). On a CUDA tensor :func:`flash_fwd`
  launches ``csrc/flash_fwd.cu`` and :func:`flash_bwd` ``csrc/flash_bwd.cu``.

On a CPU tensor each wrapper runs its plain einsum version
(:func:`mqa_attention_reference`, :func:`mqa_bwd_reference`,
:func:`flash_attention_reference`, :func:`flash_bwd_reference`), which the
kernels are held against on the card. Any other device raises. Every
function takes q in the projection's natural (B, N, H, D) layout, so the
projections need no transposes. Symmetric ALiBi is two equal slope rows.

Dropout acts on the post-softmax probabilities, as in the JAX package: the
normaliser uses the undropped probabilities, the value product the dropped
ones. The keep mask is a pure integer hash of a global element index plus
a seed (``_keep_hash`` there), so the forward and the backward regenerate
the same bits and nothing of shape (N, M) is stored. The two families hash
different indices, as there: the folded ``(b*N*H + n*H + h)*M + c``
(``_mqa_keep``) and the per-head ``((b*H + h)*N + n)*M + c``
(``_head_keep``), both over the unpadded N and M, mod 2**32.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.autocast import no_autocast

NEG_INF = -1e30
HEAD_DIM = 64
_M32 = 0xFFFFFFFF

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dropout_thresh(rate: float) -> int:
    """8-bit keep threshold: keep iff (hash >> 24) < thresh, a keep
    probability of round((1 - rate) * 256) / 256."""
    return int(round((1.0 - rate) * 256.0))


def drop_params(rate: float) -> tuple[int, float] | None:
    """(thresh, 1 / (1 - rate)), or None where the rate means no dropout
    (0, or small enough to quantise to keep-everything)."""
    if not rate:
        return None
    thresh = dropout_thresh(rate)
    if thresh >= 256:
        return None
    return thresh, 1.0 / (1.0 - rate)


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """u * c mod 2**32 for int64 u in [0, 2**32), without int64 overflow."""
    return (u * (c & 0xFFFF) + (((u * (c >> 16)) & 0xFFFF) << 16)) & _M32


def keep_hash(idx: torch.Tensor, seed, thresh: int) -> torch.Tensor:
    """The JAX package's ``_keep_hash`` in int64 arithmetic masked to 32
    bits after every step: bool keep mask of int64 indices ``idx``."""
    u = (idx + seed) & _M32
    u = _mul32(u, 2654435761)
    u = u ^ (u >> 17)
    u = _mul32(u, 0x45D9F3B)
    return (u >> 24) < thresh


def mqa_keep_mask(B: int, N: int, H: int, M: int, seed: torch.Tensor,
                  thresh: int) -> torch.Tensor:
    """(B, N, H, M) keep mask; element (b, n, h, c) hashes the folded index
    (b * N*H + n*H + h) * M + c with the (1,) int32 ``seed``."""
    idx = torch.arange(B * N * H * M, dtype=torch.int64, device=seed.device)
    return keep_hash(idx, seed.to(torch.int64), thresh).reshape(B, N, H, M)


def head_keep_mask(B: int, H: int, N: int, M: int, seed: torch.Tensor,
                   thresh: int) -> torch.Tensor:
    """(B, H, N, M) keep mask; element (b, h, n, c) hashes the per-head
    index ((b*H + h)*N + n)*M + c with the (1,) int32 ``seed``."""
    idx = torch.arange(B * H * N * M, dtype=torch.int64, device=seed.device)
    return keep_hash(idx, seed.to(torch.int64), thresh).reshape(B, H, N, M)


def _geometry(N, M, offset, slopes, device):
    """(dist (N, M), lower (N, M), bias (N, H, M)) of the in-kernel ALiBi."""
    n = torch.arange(N, device=device)[:, None]
    c = torch.arange(M, device=device)[None, :]
    dist = -(c - n - offset).abs().float()
    lower = c <= n + offset
    sl = slopes.float()
    bias = torch.where(lower[:, None, :], sl[0][None, :, None] * dist[:, None, :],
                       sl[1][None, :, None] * dist[:, None, :])
    return dist, lower, bias


def _valid(key_lens, lower, causal, M, device):
    """(B, N|1, 1, M) bool: keys each query may attend."""
    c = torch.arange(M, device=device)[None, :]
    valid = c[None] < key_lens.to(device)[:, None, None]  # (B, 1, M)
    if causal:
        valid = valid & lower[None]
    return valid[:, :, None, :]


def _keep(drop, mask_fn):
    """The dropped probabilities' multiplier (B, N, H, M), or None."""
    if drop is None:
        return None
    return mask_fn(drop[0]) * drop[1]


def _heads(k, H):
    """k/v (B, M, Hkv, D) as (B, M, H, D) f32: one key/value head is shared."""
    kf = k.float()
    return kf.expand(-1, -1, H, -1) if kf.shape[2] == 1 else kf


@no_autocast
def _attention_reference(q, k, v, slopes, key_lens, scale, offset, q_lens, causal, keep):
    """The plain forward of both families: q (B, N, H, D), k/v (B, M, Hkv,
    D), ``keep`` from :func:`_keep`. Returns (o in q's dtype, lse (B, N, H)
    f32, +inf on dead rows)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    dev = q.device
    _, lower, bias = _geometry(N, M, offset, slopes, dev)
    s = torch.einsum("bnhd,bmhd->bnhm", q.float(), _heads(k, H)) * scale + bias[None]
    valid = _valid(key_lens, lower, causal, M, dev)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    if keep is not None:
        p = p * keep
    o = torch.einsum("bnhm,bmhd->bnhd", p, _heads(v, H)) / l.clamp_min(1e-30)
    if q_lens is None:
        q_lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    q_live = torch.arange(N, device=dev)[None, :] < q_lens.to(dev)[:, None]
    live = q_live[:, :, None, None] & (l > 0)
    o = torch.where(live, o, torch.zeros((), device=dev)).to(q.dtype)
    lse = torch.where(live[..., 0], m[..., 0] + torch.log(l.clamp_min(1e-30))[..., 0],
                      torch.full((), float("inf"), device=dev))
    return o, lse


@no_autocast
def _attention_bwd_reference(q, k, v, slopes, key_lens, o, lse, do, scale, offset,
                             causal, keep):
    """The plain backward of both families from the saved o and lse
    (B, N, H). Returns (dq, dk, dv in their inputs' dtypes, dk/dv summed
    over the heads that share a key/value head; dslopes (2, H) f32)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    dev = q.device
    dist, lower, bias = _geometry(N, M, offset, slopes, dev)
    qf, kf, vf, dof = q.float(), _heads(k, H), _heads(v, H), do.float()
    s = torch.einsum("bnhd,bmhd->bnhm", qf, kf) * scale + bias[None]
    s = s.masked_fill(~_valid(key_lens, lower, causal, M, dev), NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bnhd,bmhd->bnhm", dof, vf)
    pv = p
    if keep is not None:
        pv = p * keep
        dp = dp * keep
    dv = torch.einsum("bnhm,bnhd->bmhd", pv, dof)
    ds = p * (dp - delta)
    dq = torch.einsum("bnhm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bnhm,bnhd->bmhd", ds, qf) * scale
    if k.shape[2] == 1:
        dk, dv = dk.sum(dim=2, keepdim=True), dv.sum(dim=2, keepdim=True)
    dsd = ds * dist[None, :, None, :]
    low = lower[None, :, None, :]
    dslopes = torch.stack([torch.where(low, dsd, 0.0).sum(dim=(0, 1, 3)),
                           torch.where(low, 0.0, dsd).sum(dim=(0, 1, 3))])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dslopes


def mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset=0,
                            q_lens=None, causal=False, dropout_rate=0.0, seed=None):
    """Plain version of K1. Shapes as in :func:`mqa_fwd`; math in f32.

    Returns (o (B, N, H, D) in q's dtype, lse (B, N*H) f32).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate),
                 lambda thresh: mqa_keep_mask(B, N, H, M, seed, thresh))
    o, lse = _attention_reference(q, k[:, :, None], v[:, :, None], slopes, key_lens,
                                  scale, offset, q_lens, causal, keep)
    return o, lse.reshape(B, N * H)


def mqa_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
                      offset=0, causal=False, dropout_rate=0.0):
    """Plain version of K2: the gradients of K1's o from the saved o and lse.

    p is recomputed as exp(s - lse) (0 on dead rows, whose lse is +inf);
    delta = rowsum(dO * O); with dropout the mask multiplies p in dv and dp.
    Returns (dq, dk, dv in their inputs' dtypes, dslopes (2, H) f32 split by
    the lower and upper triangle).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate),
                 lambda thresh: mqa_keep_mask(B, N, H, M, seed, thresh))
    dq, dk, dv, dslopes = _attention_bwd_reference(
        q, k[:, :, None], v[:, :, None], slopes, key_lens, o, lse.reshape(B, N, H), do,
        scale, offset, causal, keep)
    return dq, dk[:, :, 0], dv[:, :, 0], dslopes


def flash_attention_reference(q, k, v, slopes, key_lens, scale, offset=0,
                              q_lens=None, causal=False, dropout_rate=0.0, seed=None):
    """Plain version of K5a. Shapes as in :func:`flash_fwd`; math in f32.

    Returns (o (B, N, H, D) in q's dtype, lse (B, H, N) f32).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: head_keep_mask(
        B, H, N, M, seed, thresh).permute(0, 2, 1, 3))
    o, lse = _attention_reference(q, k, v, slopes, key_lens, scale, offset, q_lens,
                                  causal, keep)
    return o, lse.transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
                        offset=0, causal=False, dropout_rate=0.0):
    """Plain version of K5b: the gradients of K5a's o from the saved o and
    lse (B, H, N), as :func:`mqa_bwd_reference` does for K1. Returns (dq,
    dk, dv in their inputs' dtypes, dk/dv (B, M, Hkv, D) summed over the
    heads when Hkv = 1; dslopes (2, H) f32)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: head_keep_mask(
        B, H, N, M, seed, thresh).permute(0, 2, 1, 3))
    return _attention_bwd_reference(q, k, v, slopes, key_lens, o, lse.transpose(1, 2),
                                    do, scale, offset, causal, keep)


def _check(q, k, v, slopes, key_lens, q_lens, seed, *more, per_head=False):
    """Raise on what the kernels do not take. k and v are (B, M, D) for the
    folded-MQA kernels, (B, M, Hkv, D) with Hkv in {1, H} with ``per_head``."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, D), got {tuple(q.shape)}")
    B, N, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"the attention kernels take head dim {HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernels take float32 or bfloat16, got {q.dtype}")
    if per_head:
        fits = k.dim() == 4 and k.shape[0] == B and k.shape[2] in (1, H) and k.shape[3] == D
        want = "(B, M, Hkv, D) with Hkv 1 or H"
    else:
        fits = k.dim() == 3 and k.shape[0] == B and k.shape[2] == D
        want = "(B, M, D)"
    if not fits or v.shape != k.shape:
        raise ValueError(f"k and v must be {want}: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if slopes.shape != (2, H) or slopes.dtype != torch.float32:
        raise ValueError(f"slopes must be (2, {H}) float32")
    if not per_head and H > 64:
        raise ValueError(f"the folded-MQA kernels take at most 64 heads, got {H}")
    for name, lens in (("key_lens", key_lens), ("q_lens", q_lens)):
        if lens.shape != (B,) or lens.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B},) int32")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError("seed must be (1,) int32")
    for i, t in enumerate((q, k, v, slopes, key_lens, q_lens, seed, *more)):
        if t.device != q.device:
            raise ValueError(f"argument {i} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"argument {i} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"argument {i} must be 16-byte aligned")


def _kernel(name: str, symbol: str, argtypes: list):
    """A built kernel entry point, with its C signature declared."""
    from .cuda_build import load

    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _defaults(q, q_lens, seed):
    if q_lens is None:
        q_lens = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                            device=q.device)
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
    return q_lens, seed


def mqa_fwd(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
            causal=False, dropout_rate=0.0, seed=None):
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
      dropout_rate: probability dropout; seed: (1,) int32 on q's device.

    Returns:
      (o (B, N, H, 64) in q's dtype, lse (B, N*H) float32 row logsumexp,
      +inf on rows that attended nothing).
    """
    q_lens, seed = _defaults(q, q_lens, seed)
    if q.device.type == "cpu":
        return mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset,
                                       q_lens, causal, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v, slopes, key_lens, q_lens, seed)
    B, N, H, _ = q.shape
    M = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((B, N * H), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    fn = _kernel("mqa_fwd", "isp_mqa_fwd", [_P] * 9 + [_I] * 6 + [_F, _I, _F, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
             key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, N, M, H, int(offset), int(bool(causal)),
             float(scale), thresh, inv_keep, _DTYPE_CODES[q.dtype],
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"K1 mqa_fwd launch failed: CUDA error {err}")
    mqa_fwd.launches += 1
    return o, lse


#: kernel launches since the count was last set to 0 (CPU calls never count)
mqa_fwd.launches = 0


def _dkv_splits(tiles: int) -> int:
    """Row-range splits of the backward's dk/dv pass (K2, K5b), given the
    64-row tiles each of its key-stationary blocks walks: at least 7 tiles
    a split, at most 8 splits (measured on the H100 at the decoder's bf16
    training shape and at M 3072, PERF.md §6). The splits write f32 partial
    sums that a third launch adds in a fixed order."""
    return max(1, min(8, tiles // 7))


def _dkv_work(splits: int, k: torch.Tensor):
    """The splits' f32 partial dk and dv, or None for one split."""
    if splits == 1:
        return None
    return torch.empty((splits, 2, *k.shape), dtype=torch.float32, device=k.device)


def mqa_bwd(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
            offset=0, causal=False, dropout_rate=0.0):
    """Folded-MQA attention backward: (dq, dk, dv, dslopes (2, H) f32).

    The arguments are K1's, its outputs o and lse, and do = dL/do. dk and
    dv are (B, M, 64), summed over the H heads that share the key/value row.
    """
    if q.device.type == "cpu":
        return mqa_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do,
                                 scale, offset, causal, dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q's shape and dtype")
    B, N, H, _ = q.shape
    M = k.shape[1]
    if lse.shape != (B, N * H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {N * H}) float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dslopes = torch.zeros((2, H), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), dslopes
    # each dk/dv block walks H * ceil(N/64) row tiles
    splits = _dkv_splits(H * -(-N // 64))
    delta = torch.empty((B, N * H), dtype=torch.float32, device=q.device)
    work = _dkv_work(splits, k)
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    fn = _kernel("mqa_bwd", "isp_mqa_bwd",
                 [_P] * 16 + [_I] * 6 + [_F, _I, _F, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
             key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dslopes.data_ptr(), delta.data_ptr(),
             None if work is None else work.data_ptr(), B, N, M, H, int(offset),
             int(bool(causal)), float(scale), thresh, inv_keep, splits,
             _DTYPE_CODES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"K2 mqa_bwd launch failed: CUDA error {err}")
    mqa_bwd.launches += 1
    return dq, dk, dv, dslopes


#: kernel launches since the count was last set to 0 (CPU calls never count)
mqa_bwd.launches = 0


def flash_fwd(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
              causal=False, dropout_rate=0.0, seed=None):
    """Per-head attention forward.

    Args:
      q: (B, N, H, 64) float32 or bfloat16 (the q projection's layout).
      k, v: (B, M, Hkv, 64), q's dtype, Hkv = H (one key/value head per
        query head) or 1 (one shared by all).
      slopes, key_lens, scale, offset, q_lens, causal, dropout_rate, seed:
        as in :func:`mqa_fwd`; the dropout mask is the per-head hash.

    Returns:
      (o (B, N, H, 64) in q's dtype, lse (B, H, N) float32 row logsumexp,
      +inf on rows that attended nothing).
    """
    q_lens, seed = _defaults(q, q_lens, seed)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, slopes, key_lens, scale, offset,
                                         q_lens, causal, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"K5a runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v, slopes, key_lens, q_lens, seed, per_head=True)
    B, N, H, _ = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    fn = _kernel("flash_fwd", "isp_flash_fwd", [_P] * 9 + [_I] * 7 + [_F, _I, _F, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
             key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, N, M, H, Hkv, int(offset), int(bool(causal)),
             float(scale), thresh, inv_keep, _DTYPE_CODES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"K5a flash_fwd launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


#: kernel launches since the count was last set to 0 (CPU calls never count)
flash_fwd.launches = 0


def flash_bwd(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
              offset=0, causal=False, dropout_rate=0.0):
    """Per-head attention backward: (dq, dk, dv, dslopes (2, H) f32).

    The arguments are K5a's, its outputs o and lse, and do = dL/do. dk and
    dv have k's shape; with Hkv = 1 they are summed over the H heads.
    """
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do,
                                   scale, offset, causal, dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"K5b runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, per_head=True)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q's shape and dtype")
    B, N, H, _ = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {N}) float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dslopes = torch.zeros((2, H), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), dslopes
    # each dk/dv block walks ceil(N/64) row tiles of its head (Hkv = H) or
    # of every head (Hkv = 1)
    splits = _dkv_splits((1 if Hkv != 1 else H) * -(-N // 64))
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    work = _dkv_work(splits, k)
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    fn = _kernel("flash_bwd", "isp_flash_bwd",
                 [_P] * 16 + [_I] * 7 + [_F, _I, _F, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
             key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dslopes.data_ptr(), delta.data_ptr(),
             None if work is None else work.data_ptr(), B, N, M, H, Hkv, int(offset),
             int(bool(causal)), float(scale), thresh, inv_keep, splits,
             _DTYPE_CODES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"K5b flash_bwd launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return dq, dk, dv, dslopes


#: kernel launches since the count was last set to 0 (CPU calls never count)
flash_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """A kernel forward (K1 or K5a) and its kernel backward (K2 or K5b),
    or their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, kernels, q, k, v, slopes, key_lens, q_lens, seed, scale, offset,
                causal, dropout_rate):
        fwd, ctx.bwd = kernels
        o, lse = fwd(q, k, v, slopes, key_lens, scale, offset, q_lens, causal,
                     dropout_rate, seed)
        ctx.save_for_backward(q, k, v, slopes, key_lens, q_lens, seed, o, lse)
        ctx.args = (scale, offset, causal, dropout_rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, slopes, key_lens, q_lens, seed, o, lse = ctx.saved_tensors
        dq, dk, dv, dslopes = ctx.bwd(q, k, v, slopes, key_lens, q_lens, seed, o, lse,
                                      do.contiguous(), *ctx.args)
        return None, dq, dk, dv, dslopes, None, None, None, None, None, None, None


def mqa_attention(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
                  causal=False, dropout_rate=0.0, seed=None):
    """Differentiable folded-MQA attention: :func:`mqa_fwd`'s output o, with
    :func:`mqa_bwd` as its backward. Arguments as in :func:`mqa_fwd`."""
    q_lens, seed = _defaults(q, q_lens, seed)
    return _FlashAttention.apply((mqa_fwd, mqa_bwd), q, k, v, slopes, key_lens, q_lens,
                                 seed, scale, offset, causal, dropout_rate)


def flash_attention(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
                    causal=False, dropout_rate=0.0, seed=None):
    """Differentiable per-head attention: :func:`flash_fwd`'s output o, with
    :func:`flash_bwd` as its backward. Arguments as in :func:`flash_fwd`."""
    q_lens, seed = _defaults(q, q_lens, seed)
    return _FlashAttention.apply((flash_fwd, flash_bwd), q, k, v, slopes, key_lens,
                                 q_lens, seed, scale, offset, causal, dropout_rate)
