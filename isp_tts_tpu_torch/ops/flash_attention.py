"""Attention kernels and their plain versions: the folded-MQA forward (K1)
and backward (K2), the per-head forward (K5a) and backward (K5b), and the
registered operators that join a forward to its backward.

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

Each forward and its backward are one registered operator,
``isp_tts::mqa_fwd`` or ``isp_tts::flash_fwd`` (:func:`mqa_attention`,
:func:`flash_attention`), which the attention layers call in training and
in serving and which ``torch.export`` keeps as a node of an exported
program.

On a CPU tensor each wrapper runs its plain einsum version
(:func:`mqa_attention_reference`, :func:`mqa_bwd_reference`,
:func:`flash_attention_reference`, :func:`flash_bwd_reference`), which the
kernels are held against on the card. Any other device raises. Every
function takes q in the projection's natural (B, N, H, D) layout, so the
projections need no transposes. Symmetric ALiBi is two equal slope rows.

Head dims: the kernels take every D from 1 to :data:`HEAD_DIM_MAX` (128).
Each source is built once per tile width of :data:`HEAD_TILES`, and a call
launches the least width >= D (:func:`kernel_library`). A D that is a
multiple of 8 launches as it is; any other D is zero-padded along the head
dim to the next multiple of 8 (:func:`pad_head_dim`, one copy a tensor),
launched and sliced back, which is exact: the caller's scale is kept, and
zero columns add nothing to q.k and give zero columns of o, dq, dk and dv.
A larger D raises. The plain versions take any D.

Dropout acts on the post-softmax probabilities, as in the JAX package: the
normaliser uses the undropped probabilities, the value product the dropped
ones. The keep mask is a pure integer hash of a global element index plus
a seed (``_keep_hash`` there), so the forward and the backward regenerate
the same bits and nothing of shape (N, M) is stored. The two families hash
different indices, as there: the folded ``(b*N*H + n*H + h)*M + c``
(``_mqa_keep``) and the per-head ``((b*H + h)*N + n)*M + c``
(``_head_keep``), both over the unpadded N and M, mod 2**32.

Under a data or model split (``parallel/``) the index stays the global
call's: every function takes ``batch0`` (the global index of its first
batch row), ``head0`` (of its first head) and ``heads_total`` (the global
head count, H by default), so a rank's keep mask is the slice of the
global call's mask that its rows and heads see. The kernels take the
global head count as the index's head stride and the first row's and
head's offset folded into the seed (:func:`hash_origin`); with the
defaults both reduce to one rank's call and the JAX masks.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.autocast import no_autocast
from .cuda_build import launch_stream

NEG_INF = -1e30
#: the largest head dim the kernels take
HEAD_DIM_MAX = 128
#: the tile widths each attention source is built at (``-DATT_TILE_D``)
HEAD_TILES = (16, 32, 64, 128)
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


def hash_origin(folded: bool, N: int, M: int, H: int, batch0: int = 0, head0: int = 0,
                heads_total: int | None = None) -> tuple[int, int]:
    """(the index's head count, the seed shift) a kernel takes for a call
    whose first batch row and head are ``batch0`` and ``head0`` of a
    global call with ``heads_total`` heads: the global index of the call's
    first element, mod 2**32 (0 on one rank)."""
    hh = H if heads_total is None else int(heads_total)
    if hh < H + head0:
        raise ValueError(f"heads {head0}..{head0 + H} exceed heads_total {hh}")
    first = (batch0 * N * hh + head0) * M if folded else (batch0 * hh + head0) * N * M
    return hh, first & _M32


def _grid(dev, *ranges):
    """Broadcastable int64 aranges, one axis each: ``ranges`` of (start, n)."""
    out = []
    for i, (start, n) in enumerate(ranges):
        shape = [1] * len(ranges)
        shape[i] = n
        out.append(torch.arange(start, start + n, dtype=torch.int64, device=dev).reshape(shape))
    return out


def mqa_keep_mask(B: int, N: int, H: int, M: int, seed: torch.Tensor, thresh: int,
                  batch0: int = 0, head0: int = 0,
                  heads_total: int | None = None) -> torch.Tensor:
    """(B, N, H, M) keep mask; element (b, n, h, c) hashes the folded index
    ((B0 + b)*N + n)*HH + H0 + h)*M + c with the (1,) int32 ``seed``, where
    B0, H0, HH are ``batch0``, ``head0``, ``heads_total`` (H)."""
    hh = H if heads_total is None else int(heads_total)
    b, n, h, c = _grid(seed.device, (batch0, B), (0, N), (head0, H), (0, M))
    idx = ((b * N + n) * hh + h) * M + c
    return keep_hash(idx, seed.to(torch.int64), thresh)


def head_keep_mask(B: int, H: int, N: int, M: int, seed: torch.Tensor, thresh: int,
                   batch0: int = 0, head0: int = 0,
                   heads_total: int | None = None) -> torch.Tensor:
    """(B, H, N, M) keep mask; element (b, h, n, c) hashes the per-head
    index (((B0 + b)*HH + H0 + h)*N + n)*M + c with the (1,) int32 ``seed``."""
    hh = H if heads_total is None else int(heads_total)
    b, h, n, c = _grid(seed.device, (batch0, B), (head0, H), (0, N), (0, M))
    idx = ((b * hh + h) * N + n) * M + c
    return keep_hash(idx, seed.to(torch.int64), thresh)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' math type: f32, or f64 for an f64 input
    (an exact reference to hold f32 results against)."""
    return x.double() if x.dtype == torch.float64 else x.float()


def _geometry(N, M, offset, slopes, device):
    """(dist (N, M), lower (N, M), bias (N, H, M)) of the in-kernel ALiBi,
    in the slopes' math type (:func:`_wide`)."""
    n = torch.arange(N, device=device)[:, None]
    c = torch.arange(M, device=device)[None, :]
    sl = _wide(slopes)
    dist = -(c - n - offset).abs().to(sl.dtype)
    lower = c <= n + offset
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


def _slope_arms(key_lens, offset, causal, N, M, device, dtype):
    """(B, N, 1, M) -|c - c*| with c* the key nearest n + offset of those
    query n may attend: each key's distance from the row's nearest valid
    key, in the slope gradients' sums. Where a row's valid keys straddle
    n + offset, c* = n + offset and this is the ALiBi distance; where they
    all lie on one side (a far offset, a query past the key length) the
    two differ by a constant of the row, over which ds sums to zero in
    exact arithmetic. Summed over the ALiBi distance instead, delta's error
    (rowsum(dO * O) on the forward's rounded o) times that constant (up to
    |offset|) swamps the slope gradient: 1e-2 of it in f32 and O(1) in
    bf16 at a cross-attention offset of -832 on an H100."""
    nb = torch.arange(N, device=device) + offset  # (N,)
    lim = key_lens.to(device).long().clamp(0, M)[:, None].expand(-1, N)  # keys [0, lim)
    if causal:
        lim = torch.minimum(lim, (nb + 1).clamp_min(0)[None, :])
    near = torch.minimum(nb.clamp_min(0)[None, :], (lim - 1).clamp_min(0))  # (B, N)
    c = torch.arange(M, device=device)
    return -(c[None, None, :] - near[..., None]).abs().to(dtype)[:, :, None, :]


def _keep(drop, mask_fn):
    """The dropped probabilities' multiplier (B, N, H, M), or None."""
    if drop is None:
        return None
    return mask_fn(drop[0]) * drop[1]


def _heads(k, H):
    """k/v (B, M, Hkv, D) as (B, M, H, D) in their math type (:func:`_wide`):
    one key/value head is shared."""
    kf = _wide(k)
    return kf.expand(-1, -1, H, -1) if kf.shape[2] == 1 else kf


@no_autocast
def _attention_reference(q, k, v, slopes, key_lens, scale, offset, q_lens, causal, keep):
    """The plain forward of both families: q (B, N, H, D), k/v (B, M, Hkv,
    D), ``keep`` from :func:`_keep`; math in f32, or in f64 for f64 inputs.
    Returns (o in q's dtype, lse (B, N, H) in the math type, +inf on dead
    rows)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    dev = q.device
    _, lower, bias = _geometry(N, M, offset, slopes, dev)
    s = torch.einsum("bnhd,bmhd->bnhm", _wide(q), _heads(k, H)) * scale + bias[None]
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
    over the heads that share a key/value head; dslopes (2, H) in the math
    type: f32, or f64 for f64 inputs)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    dev = q.device
    _, lower, bias = _geometry(N, M, offset, slopes, dev)
    qf, kf, vf, dof = _wide(q), _heads(k, H), _heads(v, H), _wide(do)
    s = torch.einsum("bnhd,bmhd->bnhm", qf, kf) * scale + bias[None]
    s = s.masked_fill(~_valid(key_lens, lower, causal, M, dev), NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (dof * _wide(o)).sum(dim=-1, keepdim=True)
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
    dsd = ds * _slope_arms(key_lens, offset, causal, N, M, dev, ds.dtype)
    low = lower[None, :, None, :]
    dslopes = torch.stack([torch.where(low, dsd, 0.0).sum(dim=(0, 1, 3)),
                           torch.where(low, 0.0, dsd).sum(dim=(0, 1, 3))])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dslopes


def mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset=0,
                            q_lens=None, causal=False, dropout_rate=0.0, seed=None,
                            batch0=0, head0=0, heads_total=None):
    """Plain version of K1. Shapes as in :func:`mqa_fwd`; math in f32 (f64
    for f64 inputs).

    Returns (o (B, N, H, D) in q's dtype, lse (B, N*H) f32).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: mqa_keep_mask(
        B, N, H, M, seed, thresh, batch0, head0, heads_total))
    o, lse = _attention_reference(q, k[:, :, None], v[:, :, None], slopes, key_lens,
                                  scale, offset, q_lens, causal, keep)
    return o, lse.reshape(B, N * H)


def mqa_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
                      offset=0, causal=False, dropout_rate=0.0, batch0=0, head0=0,
                      heads_total=None):
    """Plain version of K2: the gradients of K1's o from the saved o and lse.

    p is recomputed as exp(s - lse) (0 on dead rows, whose lse is +inf);
    delta = rowsum(dO * O); with dropout the mask multiplies p in dv and dp.
    Returns (dq, dk, dv in their inputs' dtypes, dslopes (2, H) f32 split by
    the lower and upper triangle).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: mqa_keep_mask(
        B, N, H, M, seed, thresh, batch0, head0, heads_total))
    dq, dk, dv, dslopes = _attention_bwd_reference(
        q, k[:, :, None], v[:, :, None], slopes, key_lens, o, lse.reshape(B, N, H), do,
        scale, offset, causal, keep)
    return dq, dk[:, :, 0], dv[:, :, 0], dslopes


def flash_attention_reference(q, k, v, slopes, key_lens, scale, offset=0,
                              q_lens=None, causal=False, dropout_rate=0.0, seed=None,
                              batch0=0, head0=0, heads_total=None):
    """Plain version of K5a. Shapes as in :func:`flash_fwd`; math in f32
    (f64 for f64 inputs).

    Returns (o (B, N, H, D) in q's dtype, lse (B, H, N) f32).
    """
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: head_keep_mask(
        B, H, N, M, seed, thresh, batch0, head0, heads_total).permute(0, 2, 1, 3))
    o, lse = _attention_reference(q, k, v, slopes, key_lens, scale, offset, q_lens,
                                  causal, keep)
    return o, lse.transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
                        offset=0, causal=False, dropout_rate=0.0, batch0=0, head0=0,
                        heads_total=None):
    """Plain version of K5b: the gradients of K5a's o from the saved o and
    lse (B, H, N), as :func:`mqa_bwd_reference` does for K1. Returns (dq,
    dk, dv in their inputs' dtypes, dk/dv (B, M, Hkv, D) summed over the
    heads when Hkv = 1; dslopes (2, H) f32)."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    keep = _keep(drop_params(dropout_rate), lambda thresh: head_keep_mask(
        B, H, N, M, seed, thresh, batch0, head0, heads_total).permute(0, 2, 1, 3))
    return _attention_bwd_reference(q, k, v, slopes, key_lens, o, lse.transpose(1, 2),
                                    do, scale, offset, causal, keep)


@no_autocast
def masked_attention(q, k, v, scale, bias=None, mask=None, causal=False, drop=None):
    """Attention with an additive bias and a boolean mask: the counterpart of
    ``isp_tts_tpu/ops/attention.py:scaled_dot_product_attention``, the plain
    path of calls the kernels do not take (an explicit attention mask,
    cross-attention under "auto"). No kernel stands behind it.

    q (B, N, H, D), k/v (B, M, Hkv, D) with Hkv in {1, H}; ``bias``
    broadcastable to (B, H, N, M) (ALiBi); ``mask`` bool broadcastable to
    (B, H, N, M), True = attend; ``causal`` lets query i see keys up to
    i + M - N; ``drop`` maps the (B, H, N, M) probabilities to their dropped
    values (after the normaliser, as there). Math in f32 (f64 for f64
    inputs); fully masked query rows give zeros. Returns (B, N, H, D) in q's dtype.
    """
    H = q.shape[2]
    n, m = q.shape[1], k.shape[1]
    logits = torch.einsum("bnhd,bmhd->bhnm", _wide(q), _heads(k, H)) * scale
    if bias is not None:
        logits = logits + _wide(bias)
    if causal:
        lower = (torch.arange(m, device=q.device)[None, :]
                 <= torch.arange(n, device=q.device)[:, None] + (m - n))
        mask = lower if mask is None else mask & lower
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    if mask is not None:
        unnorm = torch.where(mask, unnorm, torch.zeros((), device=q.device))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if drop is not None:
        probs = drop(probs)
    return torch.einsum("bhnm,bmhd->bnhd", probs, _heads(v, H)).to(q.dtype)


def head_tile(D: int) -> int:
    """The tile width a kernel of head dim ``D`` (1 .. HEAD_DIM_MAX) runs at."""
    for tile in HEAD_TILES:
        if D <= tile:
            return tile
    raise ValueError(f"the attention kernels take head dims up to {HEAD_DIM_MAX}, got {D}; "
                     "set flash: off for the plain version")


def kernel_library(source: str, D: int) -> str:
    """The library (``ops/cuda_build.py``) of attention ``source`` that a
    call of head dim ``D`` launches: the source built at :func:`head_tile`."""
    return f"{source}_d{head_tile(D)}"


def pad_head_dim(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor zero-padded along its last (head) dim to the next multiple
    of 8, in one copy: the kernels' operands for a head dim they do not
    launch at directly."""
    D = xs[0].shape[-1]
    pad = -D % 8
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def _head_dim(q) -> int:
    """q's head dim; raises on a q that is not (B, N, H, D) or on D past
    :data:`HEAD_DIM_MAX`."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, D), got {tuple(q.shape)}")
    D = q.shape[3]
    if not 1 <= D <= HEAD_DIM_MAX:
        raise ValueError(f"the attention kernels take head dims up to {HEAD_DIM_MAX}, "
                         f"got {D}; set flash: off for the plain version")
    return D


def _check(q, k, v, slopes, key_lens, q_lens, seed, *more, per_head=False):
    """Raise on what the kernels do not take. k and v are (B, M, D) for the
    folded-MQA kernels, (B, M, Hkv, D) with Hkv in {1, H} with ``per_head``;
    D a multiple of 8 up to :data:`HEAD_DIM_MAX` (the wrappers pad another)."""
    D = _head_dim(q)
    B, N, H, _ = q.shape
    if D % 8:
        raise ValueError(f"the kernels launch at head dims that are multiples of 8, got {D}")
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


#: kernel launches by library (:func:`kernel_library`) since the counts were
#: last cleared: each wrapper adds one here where it adds one to its own
#: ``launches`` (CPU calls never count)
LIBRARY_LAUNCHES: dict[str, int] = {}


def _counted(fn, library: str) -> None:
    """One launch of ``library`` by wrapper ``fn``."""
    fn.launches += 1
    LIBRARY_LAUNCHES[library] = LIBRARY_LAUNCHES.get(library, 0) + 1


def _kernel(name: str, symbol: str, argtypes: list):
    """A built kernel entry point, with its C signature declared."""
    from .cuda_build import load

    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def _defaults(q, q_lens, seed):
    if q_lens is None:
        q_lens = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                            device=q.device)
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
    return q_lens, seed


def mqa_fwd(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
            causal=False, dropout_rate=0.0, seed=None, batch0=0, head0=0,
            heads_total=None):
    """Folded-MQA attention forward.

    Args:
      q: (B, N, H, D) float32 or bfloat16, D <= 128; row n*H + h is query
        n, head h.
      k, v: (B, M, D), q's dtype — the one shared key/value head.
      slopes: (2, H) float32 [lower, upper] ALiBi slopes (equal rows for
        symmetric ALiBi; zeros disable the bias).
      key_lens: (B,) int32 valid key counts.
      scale: logit scale. offset: the query-to-key diagonal offset.
      q_lens: optional (B,) int32 valid query counts; rows past them give 0.
      causal: query n attends keys <= n + offset only.
      dropout_rate: probability dropout; seed: (1,) int32 on q's device.
      batch0, head0, heads_total: where this call sits in a global call
        whose dropout mask it must slice (the module docstring).

    Returns:
      (o (B, N, H, D) in q's dtype, lse (B, N*H) float32 row logsumexp,
      +inf on rows that attended nothing).
    """
    q_lens, seed = _defaults(q, q_lens, seed)
    if q.device.type == "cpu":
        return mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset,
                                       q_lens, causal, dropout_rate, seed, batch0, head0,
                                       heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {q.device}")
    D = _head_dim(q)
    if D % 8:
        o, lse = mqa_fwd(*pad_head_dim(q, k, v), slopes, key_lens, scale, offset, q_lens,
                         causal, dropout_rate, seed, batch0, head0, heads_total)
        return o[..., :D].contiguous(), lse
    _check(q, k, v, slopes, key_lens, q_lens, seed)
    B, N, H, _ = q.shape
    M = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((B, N * H), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    hh, shift = hash_origin(True, N, M, H, batch0, head0, heads_total)
    lib = kernel_library("mqa_fwd", D)
    fn = _kernel(lib, "isp_mqa_fwd",
                 [_P] * 9 + [_I] * 7 + [_F, _I, _F, _I, _U, _I, _P])
    with launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                 key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, N, M, H, D, int(offset), int(bool(causal)),
                 float(scale), thresh, inv_keep, hh, shift, _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"K1 mqa_fwd launch failed: CUDA error {err}")
    _counted(mqa_fwd, lib)
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


def _slope_buffer(parts: int, H: int, device) -> torch.Tensor:
    """dslopes' (2, H) f32, then zeroed rows of the dq pass's ``parts``
    partials for each (triangle, head), which the backward sums in a fixed
    order (no float atomics: the same bits on every call)."""
    return torch.zeros(2 * H * (1 + parts), dtype=torch.float32, device=device)


def mqa_bwd(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
            offset=0, causal=False, dropout_rate=0.0, batch0=0, head0=0,
            heads_total=None):
    """Folded-MQA attention backward: (dq, dk, dv, dslopes (2, H) f32).

    The arguments are K1's, its outputs o and lse, and do = dL/do. dk and
    dv are (B, M, D), summed over the H heads that share the key/value row.
    """
    if q.device.type == "cpu":
        return mqa_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do,
                                 scale, offset, causal, dropout_rate, batch0, head0,
                                 heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {q.device}")
    D = _head_dim(q)
    if D % 8:
        qp, kp, vp, op, dop = pad_head_dim(q, k, v, o, do)
        dq, dk, dv, dslopes = mqa_bwd(qp, kp, vp, slopes, key_lens, q_lens, seed, op, lse,
                                      dop, scale, offset, causal, dropout_rate, batch0,
                                      head0, heads_total)
        return (dq[..., :D].contiguous(), dk[..., :D].contiguous(),
                dv[..., :D].contiguous(), dslopes)
    _check(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q's shape and dtype")
    B, N, H, _ = q.shape
    M = k.shape[1]
    if lse.shape != (B, N * H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {N * H}) float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return (dq.zero_(), dk.zero_(), dv.zero_(),
                torch.zeros((2, H), dtype=torch.float32, device=q.device))
    # the (2, H) sums, then their partials for each batch and 64 folded rows
    dslopes = _slope_buffer(B * -(-N * H // 64), H, q.device)
    # each dk/dv block walks H * ceil(N/64) row tiles
    splits = _dkv_splits(H * -(-N // 64))
    delta = torch.empty((B, N * H), dtype=torch.float32, device=q.device)
    work = _dkv_work(splits, k)
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    hh, shift = hash_origin(True, N, M, H, batch0, head0, heads_total)
    lib = kernel_library("mqa_bwd", D)
    fn = _kernel(lib, "isp_mqa_bwd",
                 [_P] * 16 + [_I] * 7 + [_F, _I, _F, _I, _I, _U, _I, _P])
    with launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                 key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dslopes.data_ptr(), delta.data_ptr(),
                 None if work is None else work.data_ptr(), B, N, M, H, D, int(offset),
                 int(bool(causal)), float(scale), thresh, inv_keep, splits, hh, shift,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"K2 mqa_bwd launch failed: CUDA error {err}")
    _counted(mqa_bwd, lib)
    return dq, dk, dv, dslopes[:2 * H].view(2, H)


#: kernel launches since the count was last set to 0 (CPU calls never count)
mqa_bwd.launches = 0


def flash_fwd(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
              causal=False, dropout_rate=0.0, seed=None, batch0=0, head0=0,
              heads_total=None):
    """Per-head attention forward.

    Args:
      q: (B, N, H, D) float32 or bfloat16, D <= 128 (the q projection's
        layout).
      k, v: (B, M, Hkv, D), q's dtype, Hkv = H (one key/value head per
        query head) or 1 (one shared by all).
      slopes, key_lens, scale, offset, q_lens, causal, dropout_rate, seed,
        batch0, head0, heads_total: as in :func:`mqa_fwd`; the dropout mask
        is the per-head hash.

    Returns:
      (o (B, N, H, D) in q's dtype, lse (B, H, N) float32 row logsumexp,
      +inf on rows that attended nothing).
    """
    q_lens, seed = _defaults(q, q_lens, seed)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, slopes, key_lens, scale, offset,
                                         q_lens, causal, dropout_rate, seed, batch0, head0,
                                         heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"K5a runs on cuda or cpu tensors, not {q.device}")
    D = _head_dim(q)
    if D % 8:
        o, lse = flash_fwd(*pad_head_dim(q, k, v), slopes, key_lens, scale, offset, q_lens,
                           causal, dropout_rate, seed, batch0, head0, heads_total)
        return o[..., :D].contiguous(), lse
    _check(q, k, v, slopes, key_lens, q_lens, seed, per_head=True)
    B, N, H, _ = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    hh, shift = hash_origin(False, N, M, H, batch0, head0, heads_total)
    lib = kernel_library("flash_fwd", D)
    fn = _kernel(lib, "isp_flash_fwd",
                 [_P] * 9 + [_I] * 8 + [_F, _I, _F, _I, _U, _I, _P])
    with launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                 key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, N, M, H, Hkv, D, int(offset), int(bool(causal)),
                 float(scale), thresh, inv_keep, hh, shift, _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"K5a flash_fwd launch failed: CUDA error {err}")
    _counted(flash_fwd, lib)
    return o, lse


#: kernel launches since the count was last set to 0 (CPU calls never count)
flash_fwd.launches = 0


def flash_bwd(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, scale,
              offset=0, causal=False, dropout_rate=0.0, batch0=0, head0=0,
              heads_total=None):
    """Per-head attention backward: (dq, dk, dv, dslopes (2, H) f32).

    The arguments are K5a's, its outputs o and lse, and do = dL/do. dk and
    dv have k's shape; with Hkv = 1 they are summed over the H heads.
    """
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do,
                                   scale, offset, causal, dropout_rate, batch0, head0,
                                   heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"K5b runs on cuda or cpu tensors, not {q.device}")
    D = _head_dim(q)
    if D % 8:
        qp, kp, vp, op, dop = pad_head_dim(q, k, v, o, do)
        dq, dk, dv, dslopes = flash_bwd(qp, kp, vp, slopes, key_lens, q_lens, seed, op, lse,
                                        dop, scale, offset, causal, dropout_rate, batch0,
                                        head0, heads_total)
        return (dq[..., :D].contiguous(), dk[..., :D].contiguous(),
                dv[..., :D].contiguous(), dslopes)
    _check(q, k, v, slopes, key_lens, q_lens, seed, o, lse, do, per_head=True)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q's shape and dtype")
    B, N, H, _ = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {N}) float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return (dq.zero_(), dk.zero_(), dv.zero_(),
                torch.zeros((2, H), dtype=torch.float32, device=q.device))
    # the (2, H) sums, then their partials for each batch and 64 queries
    dslopes = _slope_buffer(B * -(-N // 64), H, q.device)
    # each dk/dv block walks ceil(N/64) row tiles of its head (Hkv = H) or
    # of every head (Hkv = 1)
    splits = _dkv_splits((1 if Hkv != 1 else H) * -(-N // 64))
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    work = _dkv_work(splits, k)
    thresh, inv_keep = drop_params(dropout_rate) or (256, 1.0)
    hh, shift = hash_origin(False, N, M, H, batch0, head0, heads_total)
    lib = kernel_library("flash_bwd", D)
    fn = _kernel(lib, "isp_flash_bwd",
                 [_P] * 16 + [_I] * 8 + [_F, _I, _F, _I, _I, _U, _I, _P])
    with launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
                 key_lens.data_ptr(), q_lens.data_ptr(), seed.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dslopes.data_ptr(), delta.data_ptr(),
                 None if work is None else work.data_ptr(), B, N, M, H, Hkv, D, int(offset),
                 int(bool(causal)), float(scale), thresh, inv_keep, splits, hh, shift,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"K5b flash_bwd launch failed: CUDA error {err}")
    _counted(flash_bwd, lib)
    return dq, dk, dv, dslopes[:2 * H].view(2, H)


#: kernel launches since the count was last set to 0 (CPU calls never count)
flash_bwd.launches = 0


# -- the registered operators -------------------------------------------------
#
# Each family is one operator, ``isp_tts::mqa_fwd`` (K1, backward K2) and
# ``isp_tts::flash_fwd`` (K5a, backward K5b), with its backward registered
# beside it: training, serving and ``torch.export`` all go through it. Its
# body is the wrapper above, which launches the kernel on a CUDA tensor
# (and counts it in ``mqa_fwd.launches`` / ``flash_fwd.launches``) and runs
# the plain version on a CPU tensor. ``torch.export`` traces with fake
# tensors, which have no ``data_ptr`` for the launches: the fake version
# gives the outputs' shapes, and an exported program holds one node per
# attention call that launches the kernel when it runs on the card.
# Registering needs no card and builds nothing.

Tensor = torch.Tensor
#: the operators' namespace: ``isp_tts`` for this package; a second copy of
#: it imported under another name (a study tool's parent checkout) gets its
#: own, so each copy's layers launch and count their own kernels
NAMESPACE = ("isp_tts" if __name__.split(".")[0] == "isp_tts_tpu_torch"
             else __name__.split(".")[0])


def _register(name: str, bwd_name: str, lse_shape):
    """Register ``<NAMESPACE>::<name>`` and return its overload: the
    wrapper ``name`` of this module as its body, the wrapper ``bwd_name`` as its backward (both looked up at
    each call, so a tool may swap them), ``lse_shape(B, N, H)`` for the fake
    lse. Raises where the operator is registered already."""
    if hasattr(getattr(torch.ops, NAMESPACE), name):
        raise RuntimeError(f"{NAMESPACE}::{name} is already registered: import one copy "
                           "of the package under one name per process")

    @torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=())
    def op(q: Tensor, k: Tensor, v: Tensor, slopes: Tensor, key_lens: Tensor,
           q_lens: Tensor, seed: Tensor, scale: float, offset: int, causal: bool,
           dropout_rate: float, batch0: int, head0: int,
           heads_total: int) -> tuple[Tensor, Tensor]:
        return globals()[name](q, k, v, slopes, key_lens, scale, offset, q_lens, causal,
                               dropout_rate, seed, batch0, head0, heads_total)

    @op.register_fake
    def _(q, k, v, slopes, key_lens, q_lens, seed, scale, offset, causal, dropout_rate,
          batch0, head0, heads_total):
        B, N, H, _ = q.shape
        return torch.empty_like(q), q.new_empty(lse_shape(B, N, H), dtype=torch.float32)

    def setup_context(ctx, inputs, output):
        q, k, v, slopes, key_lens, q_lens, seed, *args = inputs
        ctx.save_for_backward(q, k, v, slopes, key_lens, q_lens, seed, *output)
        ctx.args = args  # scale, offset, causal, rate, batch0, head0, heads_total

    def backward(ctx, do, _dlse):
        q, k, v, slopes, key_lens, q_lens, seed, o, lse = ctx.saved_tensors
        dq, dk, dv, dslopes = globals()[bwd_name](q, k, v, slopes, key_lens, q_lens, seed,
                                                  o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, dslopes, *[None] * 10

    op.register_autograd(backward, setup_context=setup_context)
    # the overload itself: a call skips the Python wrapper around it
    return getattr(getattr(torch.ops, NAMESPACE), name).default


mqa_op = _register("mqa_fwd", "mqa_bwd", lambda B, N, H: (B, N * H))
flash_op = _register("flash_fwd", "flash_bwd", lambda B, N, H: (B, H, N))


def mqa_attention(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
                  causal=False, dropout_rate=0.0, seed=None, batch0=0, head0=0,
                  heads_total=None):
    """Differentiable folded-MQA attention (``isp_tts::mqa_fwd``):
    :func:`mqa_fwd`'s output o, with :func:`mqa_bwd` as its backward.
    Arguments as in :func:`mqa_fwd`."""
    q_lens, seed = _defaults(q, q_lens, seed)
    return mqa_op(q, k, v, slopes, key_lens, q_lens, seed, scale, offset, causal,
                  dropout_rate, batch0, head0,
                  q.shape[2] if heads_total is None else heads_total)[0]


def flash_attention(q, k, v, slopes, key_lens, scale, offset=0, q_lens=None,
                    causal=False, dropout_rate=0.0, seed=None, batch0=0, head0=0,
                    heads_total=None):
    """Differentiable per-head attention (``isp_tts::flash_fwd``):
    :func:`flash_fwd`'s output o, with :func:`flash_bwd` as its backward.
    Arguments as in :func:`flash_fwd`."""
    q_lens, seed = _defaults(q, q_lens, seed)
    return flash_op(q, k, v, slopes, key_lens, q_lens, seed, scale, offset, causal,
                    dropout_rate, batch0, head0,
                    q.shape[2] if heads_total is None else heads_total)[0]
