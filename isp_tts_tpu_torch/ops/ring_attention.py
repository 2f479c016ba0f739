"""Ring attention: sequence-parallel ALiBi attention over the seq group.

Counterpart of ``isp_tts_tpu/ops/ring_attention.py`` (``ring_attention``,
``ring_attention_sharded``). Each of the S ranks of the seq group holds
``n_local = N / S`` query rows at their global positions and the K/V chunk
of the same rows. It folds the K/V chunk it holds into an online softmax
(running max ``m``, normaliser ``l``, output ``o``) and hands the chunk on
(:func:`~isp_tts_tpu_torch.parallel.mesh.rotate`, JAX's ``ppermute``):
S - 1 hops, the last chunk folded without one. The logits carry the
two-sided learned ALiBi at global rows and columns with ``offset``, the
global ``key_lens``, ``q_lens`` and the causal mask; rows that see no valid
key, and rows past ``q_lens``, give 0. The normaliser accumulates the
undropped weights and dropout then zeroes probabilities, as there.

The chunk products are plain ``torch.einsum``, as the JAX ring is einsum
outside any Pallas call: the products of the incoming dtype's values are
accumulated in f32 (the inputs widened to f32, which is exact for bf16),
and the probabilities are rounded to V's dtype before the second product.
One-KV-head layers use the MQA product. Autograd runs through the ring:
the rotation's backward rotates the gradient back. ``remat`` recomputes
each step's chunk logits in the backward (``torch.utils.checkpoint`` of
the fold; the rotations stay outside it).

Dropout hashes the per-head index ``((b*HH + h)*N + row)*M + col`` over
the global N and M for both families (``ring_attention.py:127-131``, not
K1's folded index), with ``b`` the global batch row (``batch0`` on) and
``h`` the global head (``head0`` on, of ``heads_total``). So the keep mask
does not depend on the shard count, and S ranks drop what one rank drops.

:func:`ring_attention_virtual` runs every rank of an S-rank ring in one
process over a list of chunks (the tests' "virtual ring"); it and
:func:`ring_attention` share :func:`_ring_rank`, and differ only in where
the step's chunk comes from.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import copy_to, rotate
from ..utils.autocast import no_autocast
from .flash_attention import NEG_INF, drop_params, keep_hash


def ring_keep_mask(B: int, H: int, rows: torch.Tensor, cols: torch.Tensor,
                   seed: torch.Tensor, thresh: int, origin) -> torch.Tensor:
    """(B, H, n, m) keep mask of the ring's dropout at query rows ``rows``
    and key columns ``cols`` (global positions): element (b, h, i, j)
    hashes ((B0 + b)*HH + H0 + h)*N + rows[i])*M + cols[j] with the (1,)
    int32 ``seed``, where ``origin`` is (B0, H0, HH, N, M)."""
    b0, h0, heads, N, M = origin
    dev = rows.device
    b = torch.arange(b0, b0 + B, dtype=torch.int64, device=dev)[:, None, None, None]
    h = torch.arange(h0, h0 + H, dtype=torch.int64, device=dev)[None, :, None, None]
    idx = ((b * heads + h) * N + rows.long()[None, None, :, None]) * M \
        + cols.long()[None, None, None, :]
    return keep_hash(idx, seed.to(device=dev, dtype=torch.int64), thresh)


@no_autocast
def accumulate(q, k_c, v_c, m, l, o, rows, cols, slopes, key_lens, scale, offset, causal,
               drop, seed, origin):
    """Fold one K/V chunk into the online softmax of this rank's queries.

    q (B, n, H, D); k_c/v_c (B, m, Hkv, D), Hkv 1 or H; m, l (B, H, n, 1)
    and o (B, H, n, D) f32; ``rows``/``cols`` the global positions of the
    queries and of the chunk's keys; ``origin`` (batch0, head0, heads,
    N, M) of the dropout index. Returns the new (m, l, o)."""
    multi_query = k_c.shape[2] == 1 and q.shape[2] != 1
    qf, kf, vf = q.float(), k_c.float(), v_c.float()
    if multi_query:
        s = torch.einsum("bnhd,bmd->bhnm", qf, kf[:, :, 0])
    else:
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
    s = s * scale
    dist_ = -(cols[None, :] - rows[:, None] - offset).abs().float()
    lower = cols[None, :] <= rows[:, None] + offset
    sl = slopes.float()[:, :, None, None]  # (2, H, 1, 1)
    s = s + torch.where(lower, sl[0] * dist_, sl[1] * dist_)
    valid = (cols[None, :] < key_lens[:, None])[:, None, None, :]
    if causal:
        valid = valid & lower[None, None]
    s = s.masked_fill(~valid, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True).detach())
    p = torch.exp(s - m_new)
    p = torch.where(valid, p, torch.zeros((), device=p.device))
    alpha = torch.exp(m - m_new)
    # the normaliser accumulates undropped weights (dropout acts on the
    # normalised probabilities)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    if drop is not None:
        keep = ring_keep_mask(q.shape[0], q.shape[2], rows, cols, seed, drop[0], origin)
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    # probabilities rounded to V's dtype for the second product
    pc = p.to(v_c.dtype).float() if v_c.dtype != torch.float32 else p
    if multi_query:
        pv = torch.einsum("bhnm,bmd->bhnd", pc, vf[:, :, 0])
    else:
        pv = torch.einsum("bhnm,bmhd->bhnd", pc, vf)
    return m_new, l, o * alpha + pv


def _ring_rank(q, chunks, me: int, S: int, slopes, key_lens, scale, offset, q_lens, causal,
               remat, dropout_rate, seed, batch0, head0, heads_total):
    """Rank ``me`` of an S-rank ring: fold the chunk ``chunks`` yields at
    each step t (the one rank ``(me - t) % S`` started with). Returns its
    (B, n_local, H, D) output in q's dtype."""
    B, n_local, H, D = q.shape
    dev = q.device
    drop = drop_params(dropout_rate) if seed is not None else None
    rows = me * n_local + torch.arange(n_local, device=dev)
    key_lens = key_lens.to(device=dev, dtype=torch.int64)
    m = torch.full((B, H, n_local, 1), NEG_INF, device=dev)
    l = torch.zeros((B, H, n_local, 1), device=dev)
    o = torch.zeros((B, H, n_local, D), device=dev)
    for t, (k_c, v_c) in enumerate(chunks):
        m_local = k_c.shape[1]
        src = (me - t) % S
        cols = src * m_local + torch.arange(m_local, device=dev)
        origin = (batch0, head0, heads_total or H, S * n_local, S * m_local)
        args = (q, k_c, v_c, m, l, o, rows, cols, slopes, key_lens, scale, offset, causal,
                drop, seed, origin)
        if remat and torch.is_grad_enabled():
            m, l, o = checkpoint(accumulate, *args, use_reentrant=False)
        else:
            m, l, o = accumulate(*args)
    ok = l[..., 0] > 0.0  # saw at least one valid key
    if q_lens is not None:
        ok = ok & (rows[None, None, :] < q_lens.to(dev)[:, None, None])
    out = o / l.clamp_min(1e-30)
    if drop is not None:
        out = out * drop[1]
    out = torch.where(ok[..., None], out, torch.zeros((), device=dev))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor,
                   key_lens: torch.Tensor, scale: float, *, group=None, offset: int = 0,
                   q_lens: torch.Tensor | None = None, causal: bool = False,
                   remat: bool = True, dropout_rate: float = 0.0,
                   seed: torch.Tensor | None = None, batch0: int = 0, head0: int = 0,
                   heads_total: int | None = None) -> torch.Tensor:
    """Sequence-parallel attention of this rank's share of the rows.

    q (B, n_local, H, D) and k/v (B, n_local, Hkv, D), Hkv 1 or H: rank i of
    the S ranks of ``group`` holds rows [i n_local, (i + 1) n_local) of
    each (None: one rank holds them all, a ring of size 1). ``slopes``
    (2, H) [lower, upper] (zeros: no bias), its gradient summed over the
    group; ``key_lens``/``q_lens`` (B,) global valid lengths; ``seed`` a
    (1,) int32 tensor every rank draws alike (dropout when not None and
    ``dropout_rate`` keeps less than everything). Returns (B, n_local, H, D)
    in q's dtype."""
    if group is None:
        S, me = 1, 0
    else:
        S, me = dist.get_world_size(group), dist.get_rank(group)
        slopes = copy_to(slopes, group)

    def chunks():
        kv = torch.stack([k, v])
        for t in range(S):
            yield kv[0], kv[1]
            if t < S - 1:  # the last chunk is folded without a hop
                kv = rotate(kv, group)

    return _ring_rank(q, chunks(), me, S, slopes, key_lens, scale, offset, q_lens, causal,
                      remat, dropout_rate, seed, batch0, head0, heads_total)


def ring_attention_virtual(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           slopes: torch.Tensor, key_lens: torch.Tensor, scale: float, *,
                           shards: int, offset: int = 0, q_lens: torch.Tensor | None = None,
                           causal: bool = False, remat: bool = True,
                           dropout_rate: float = 0.0, seed: torch.Tensor | None = None,
                           batch0: int = 0, head0: int = 0,
                           heads_total: int | None = None) -> torch.Tensor:
    """Every rank of a ``shards``-rank ring in this process: q (B, N, H, D)
    and k/v (B, N, Hkv, D) whole, cut into the ranks' row chunks; each
    rank folds the chunks in the order its ring hands them on. Returns the
    ranks' outputs joined, (B, N, H, D)."""
    S = int(shards)
    if q.shape[1] % S or k.shape[1] % S:
        raise ValueError(f"sequence {q.shape[1]} not divisible by {S} shards")
    qs, ks, vs = q.chunk(S, dim=1), k.chunk(S, dim=1), v.chunk(S, dim=1)
    outs = [_ring_rank(qs[r], ((ks[(r - t) % S], vs[(r - t) % S]) for t in range(S)), r, S,
                       slopes, key_lens, scale, offset, q_lens, causal, remat, dropout_rate,
                       seed, batch0, head0, heads_total) for r in range(S)]
    return torch.cat(outs, dim=1)
